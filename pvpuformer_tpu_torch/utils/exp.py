"""Config-file reading (pvpuformer_tpu/utils/exp.py:46-56,
isegm/utils/exp.py:177-186): the YAML file of dataset paths, config.yml."""
from __future__ import annotations


def load_config_file(config_path) -> dict:
    """The YAML mapping, its per-model `SUBCONFIGS` section dropped."""
    import yaml
    with open(config_path) as f:
        cfg = yaml.safe_load(f) or {}
    cfg.pop("SUBCONFIGS", None)
    return cfg
