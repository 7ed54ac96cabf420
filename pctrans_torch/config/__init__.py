"""Config subsystem (mirror of ``pctrans_tpu/config/``): the YACS-style
tree merged from defaults, a base YAML, an experiment YAML and ``--opts``,
plus the model configuration the port builds from it."""

import os
from typing import List, Optional

from .defaults import get_cfg_defaults
from .model import BBBC_RECIPE, CVPPP_RECIPE, ModelConfig, build_model_config, validate
from .node import CfgNode

__all__ = [
    "BBBC_RECIPE",
    "CVPPP_RECIPE",
    "CfgNode",
    "ModelConfig",
    "build_model_config",
    "get_cfg_defaults",
    "load_cfg",
    "save_all_cfg",
    "update_inference_cfg",
    "validate",
]


def load_cfg(config_base: Optional[str] = None,
             config_file: Optional[str] = None,
             opts: Optional[List[str]] = None,
             freeze: bool = True) -> CfgNode:
    """Merge defaults -> base YAML -> experiment YAML -> CLI opts."""
    cfg = get_cfg_defaults()
    if config_base:
        cfg.merge_from_file(config_base)
    if config_file:
        cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(list(opts))
    if freeze:
        cfg.freeze()
    return cfg


def update_inference_cfg(cfg: CfgNode) -> CfgNode:
    """The INFERENCE.* knobs overwrite their DATASET/MODEL counterparts (a
    defrosted copy)."""
    cfg = cfg.clone().defrost()
    if cfg.INFERENCE.INPUT_PATH:
        cfg.DATASET.INPUT_PATH = cfg.INFERENCE.INPUT_PATH
    if cfg.INFERENCE.IMAGE_NAME:
        cfg.DATASET.IMAGE_NAME = cfg.INFERENCE.IMAGE_NAME
    if cfg.INFERENCE.OUTPUT_PATH:
        cfg.DATASET.OUTPUT_PATH = cfg.INFERENCE.OUTPUT_PATH
    if cfg.INFERENCE.PAD_SIZE is not None:
        cfg.DATASET.PAD_SIZE = cfg.INFERENCE.PAD_SIZE
    if cfg.INFERENCE.get("INPUT_SIZE", None):
        cfg.MODEL.INPUT_SIZE = cfg.INFERENCE.INPUT_SIZE
    if cfg.INFERENCE.get("OUTPUT_SIZE", None):
        cfg.MODEL.OUTPUT_SIZE = cfg.INFERENCE.OUTPUT_SIZE
    cfg.SOLVER.SAMPLES_PER_BATCH = cfg.INFERENCE.SAMPLES_PER_BATCH
    return cfg


def save_all_cfg(cfg: CfgNode, output_dir: str) -> str:
    """Write the merged config to ``<output_dir>/config.yaml``."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "config.yaml")
    cfg.save(path)
    return path
