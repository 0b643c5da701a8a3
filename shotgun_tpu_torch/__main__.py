"""``python -m shotgun_tpu_torch``: the port's CLI."""

from shotgun_tpu_torch.cli import main

if __name__ == "__main__":
    main()
