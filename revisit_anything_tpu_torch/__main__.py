"""``python -m revisit_anything_tpu_torch <command> ...``: the port's CLI
(:mod:`revisit_anything_tpu_torch.cli`)."""

from revisit_anything_tpu_torch.cli import main

if __name__ == "__main__":
    main()
