"""VLAD-BuFF training on one device: aggregators, losses, the train
step, data, checkpoints and validation."""
