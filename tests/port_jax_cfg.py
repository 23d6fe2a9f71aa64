"""The JAX package's configuration for a configuration of the port: the
tests that hold the port to the JAX package build the JAX side from the
port's tree, less the keys that only the port has."""

from autonomous_driving_with_diffusion_model_tpu.utils.config import create_cfg as jax_create_cfg
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

# the port's keys that the JAX package's tree lacks
PORT_ONLY = ("MODEL.ARCH", "MODEL.STEP_EMBED_DIM", "MODEL.N_OBS_STEPS", "MODEL.OBS_FEATURE_DIM",
             "MODEL.NUM_KEYPOINTS", "MODEL.RDT", "EVAL.THRESHOLDING")


def jax_cfg_of(cfg):
    """The JAX package's default tree with the port's ``cfg`` merged in,
    less :data:`PORT_ONLY`; each of those has to hold its default, which is
    what the JAX package does."""
    default = create_cfg()
    tree = {k: (dict(v) if isinstance(v, dict) else v) for k, v in cfg.items()}
    for key in PORT_ONLY:
        section, leaf = key.split(".")
        value = tree[section].pop(leaf, default[section][leaf])
        if value != default[section][leaf]:
            raise ValueError(f"{key} {value!r}: the JAX package has no such option")
    jcfg = jax_create_cfg()
    jcfg.merge_from_other_cfg(tree)
    return jcfg
