"""VLAD-BuFF training: aggregators, losses, the train step (one device,
and data x tensor parallel over processes), data, checkpoints and
validation."""
