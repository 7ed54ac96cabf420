"""The port's config tree and YAML reader against the JAX package's
``load_cfg`` (PyYAML) on every YAML pair under ``configs/``; values compare
with their types (``1 == 1.0 == True`` in Python, not here)."""

from pathlib import Path

import pytest
import yaml

from pctrans_tpu import config as jax_config
from pctrans_torch import config
from pctrans_torch.config.node import dump_yaml, load_yaml

REPO = Path(__file__).resolve().parents[1]
PAIRS = [(REPO / "configs" / d / f"{d}-PCTrans-Base.yaml",
          REPO / "configs" / d / f"{d}-PCTrans.yaml") for d in ("CVPPP", "BBBC")]
OPTS = ["DATASET.DATA_TYPE", "synthetic", "SOLVER.ITERATION_TOTAL", "4",
        "SOLVER.BASE_LR", "1e-05", "MODEL.INPUT_SIZE", "[64, 48]",
        "SOLVER.BETAS", "(0.8, 0.9)", "MONITOR.TENSORBOARD", "False",
        "INFERENCE.OUTPUT_PATH", "/x/test", "MODEL.WEIGHTS", "r50.pkl"]


def _typed(tree):
    """The tree with every leaf paired with its type."""
    if isinstance(tree, dict):
        return {k: _typed(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_typed(v) for v in tree])
    return (type(tree).__name__, tree)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0].parent.name)
@pytest.mark.parametrize("opts", [None, OPTS], ids=["yaml", "opts"])
def test_load_cfg_equals_jax_tree(pair, opts):
    ours = config.load_cfg(str(pair[0]), str(pair[1]), opts)
    ref = jax_config.load_cfg(str(pair[0]), str(pair[1]), opts)
    assert _typed(ours.to_dict()) == _typed(ref.to_dict())
    assert ours.is_frozen()
    inf_ours = config.update_inference_cfg(ours)
    inf_ref = jax_config.update_inference_cfg(ref)
    assert _typed(inf_ours.to_dict()) == _typed(inf_ref.to_dict())
    assert not inf_ours.is_frozen() and ours.DATASET.OUTPUT_PATH != inf_ours.DATASET.OUTPUT_PATH


@pytest.mark.parametrize("path", [p for pair in PAIRS for p in pair], ids=lambda p: p.name)
def test_reader_equals_safe_load_on_the_repo_yamls(path):
    text = path.read_text()
    assert _typed(load_yaml(text)) == _typed(yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: 1e-04", "a: 1.0e-4", "a: 1.0e4", "a: .5", "a: -3", "a: +7", "a: 0",
    "a: 1_000", "a: 3.", "a: -.inf", "a: yes", "a: Off", "a: ~", "a: null", "a:",
    "a: 'it''s'", 'a: "x # not a comment"', "a: b # comment", "a: [res2, 'a,b', [1, 2.5]]",
    "a: []", "a: {}", 'a: ["9"]', "a: [[\"1\"]]", "a:\n  b:\n    c: 2\n  d: x\ne: 3",
    "# head\na:   # trailing\n  b: true\n", "a: data/CVPPP/A1   # root",
])
def test_reader_resolves_scalars_as_yaml_1_1(text):
    assert _typed(load_yaml(text)) == _typed(yaml.safe_load(text))


@pytest.mark.parametrize("text", ["a:\n  - 1\n  - 2", "a: &x 1", "a: {b: 1}",
                                  "a: 1\n   b: 2", "- 1", "a: [1, 2"])
def test_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        load_yaml(text)


def test_save_all_cfg_round_trips_and_loads_with_pyyaml(tmp_path):
    cfg = config.load_cfg(str(PAIRS[0][0]), str(PAIRS[0][1]), OPTS)
    path = config.save_all_cfg(cfg, str(tmp_path / "run"))
    assert path == str(tmp_path / "run" / "config.yaml")
    text = Path(path).read_text()
    as_lists = yaml.safe_load(dump_yaml(yaml.safe_load(yaml.safe_dump(cfg.to_dict()))))
    assert _typed(load_yaml(text)) == _typed(yaml.safe_load(text)) == _typed(as_lists)
    again = config.load_cfg(None, path)
    assert _typed(again.to_dict()) == _typed(cfg.to_dict())
    ref = jax_config.load_cfg(None, path)
    assert _typed(ref.to_dict()) == _typed(cfg.to_dict())


def test_floats_are_written_so_yaml_1_1_reads_floats():
    tree = {"a": 1e-07, "b": 2.5e+20, "c": float("inf"), "d": -0.0, "e": 1e-4}
    text = dump_yaml(tree)
    assert yaml.safe_load(text) == load_yaml(text) == tree


def test_unknown_opts_key_raises_and_frozen_cfg_refuses_writes():
    with pytest.raises(KeyError, match="Unknown config key"):
        config.load_cfg(opts=["MONITOR.ITERATION_LOG", "5"])
    cfg = config.load_cfg()
    with pytest.raises(AttributeError, match="frozen"):
        cfg.SOLVER.BASE_LR = 1.0


def test_model_config_from_the_yamls_is_the_recipe_constant():
    cfg = config.load_cfg(str(PAIRS[0][0]), str(PAIRS[0][1]))
    assert config.build_model_config(cfg) == config.CVPPP_RECIPE
