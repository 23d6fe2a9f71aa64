"""``python -m autonomous_driving_with_diffusion_model_tpu_torch.train``: the train CLI (``train/cli.py``)."""

from .cli import main, parse_args

if __name__ == "__main__":
    main(parse_args())
