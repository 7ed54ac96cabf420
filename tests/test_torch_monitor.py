"""The monitor's profiler window and the validation visualizer: the window
opens at ``start`` (or at the first iteration of a run resumed inside the
window) and closes at ``stop`` or at ``close()``, writing one Chrome trace
under ``OUTPUT_PATH/profile/``; the panels equal the JAX visualizer's; the
stdlib PNG encoder decodes back to the panel's bytes; a visualizer failure
during validation is printed and training goes on."""

import json
import struct
import zlib

import numpy as np
import pytest
import torch

from pctrans_tpu.utils.visualizer import Visualizer as JaxVisualizer
from pctrans_tpu.utils.visualizer import colorize_labels as jax_colorize
from pctrans_torch import config
from pctrans_torch.utils.monitor import Monitor, build_monitor
from pctrans_torch.utils.visualizer import Visualizer, colorize_labels, write_png

torch.set_num_threads(1)


def _run_window(tmp_path, window, iters):
    """The iterations each profiler window traced, by the record_function
    marks found in the written traces."""
    mon = Monitor(str(tmp_path), use_tensorboard=False, profile_iters=window)
    opened = []
    for it in iters:
        mon.profile_steps(it)
        if mon._profiler is not None:
            opened.append(it)
            with torch.profiler.record_function(f"iteration_{it}"):
                torch.ones(4).sum()
    mon.close()
    traces = sorted((tmp_path / "profile").glob("*.json")) if (tmp_path / "profile").exists() \
        else []
    marked = [sorted(int(e["name"].split("_")[1]) for e in
                     json.loads(t.read_text())["traceEvents"]
                     if e.get("name", "").startswith("iteration_")) for t in traces]
    return opened, [t.name for t in traces], marked


@pytest.mark.parametrize("window,iters,opened,names", [
    ((2, 4), range(0, 6), [2, 3], ["trace_000002_000004.json"]),
    ((2, 4), range(3, 6), [3], ["trace_000003_000004.json"]),          # resumed inside
    ((2, 4), range(5, 8), [], []),                                     # resumed past it
    ((1, 9), range(0, 3), [1, 2], ["trace_000001_000009.json"]),       # closed at the end
    (None, range(0, 3), [], []),
])
def test_profiler_window(tmp_path, window, iters, opened, names):
    got, traces, marked = _run_window(tmp_path, window, iters)
    assert got == opened and traces == names
    assert marked == ([opened] if opened else [])


def test_build_monitor_reads_profile_iters(tmp_path):
    cfg = config.load_cfg(opts=["DATASET.OUTPUT_PATH", str(tmp_path),
                                "MONITOR.PROFILE_ITERS", "[3, 5]", "MONITOR.TENSORBOARD",
                                "False"])
    mon = build_monitor(cfg)
    assert mon.profile_iters == (3, 5)
    mon.close()


def _decode_png(path):
    """8-bit RGB, filter 0 on every row: the stdlib encoder's format."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == \
            zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randn(2, 12, 10, 3).astype(np.float32)
    labels = rng.randint(0, 5, (2, 12, 10))
    preds = rng.randint(0, 300, (2, 12, 10))
    return images, labels, preds


def test_panels_equal_jax_and_png_decodes_to_the_panel(tmp_path):
    images, labels, preds = _batch()
    np.testing.assert_array_equal(colorize_labels(preds), jax_colorize(preds))
    ours, ref = Visualizer(str(tmp_path)), JaxVisualizer(str(tmp_path))
    panels = [ours.panel(images[b], labels[b], preds[b]) for b in range(2)]
    for b, panel in enumerate(panels):
        np.testing.assert_array_equal(panel, ref.panel(images[b], labels[b], preds[b]))
        assert panel.shape == (12, 30, 3) and panel.dtype == np.uint8
        write_png(str(tmp_path / f"p{b}.png"), panel)
        np.testing.assert_array_equal(_decode_png(tmp_path / f"p{b}.png"), panel)


def test_visualize_writes_png_without_an_image_library(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    images, labels, preds = _batch(1)
    paths = Visualizer(str(tmp_path)).visualize(7, images, labels, preds)
    assert [p.split("/")[-1] for p in paths] == ["val_000007_0.png", "val_000007_1.png"]
    vis = Visualizer(str(tmp_path))
    np.testing.assert_array_equal(_decode_png(tmp_path / "vis" / "val_000007_1.png"),
                                  vis.panel(images[1], labels[1], preds[1]))


def test_a_visualizer_failure_does_not_stop_training(tmp_path, monkeypatch, capsys):
    from pctrans_torch.engine.trainer import Trainer
    from test_torch_trainer import tiny_opts

    def broken(*args, **kwargs):
        raise RuntimeError("panel writer down")

    monkeypatch.setattr("pctrans_torch.utils.visualizer.Visualizer.visualize", broken)
    opts = tiny_opts(tmp_path) + ["SOLVER.ITERATION_TOTAL", "2", "SOLVER.ITERATION_VAL", "2",
                                  "SOLVER.ITERATION_SAVE", "2"]
    trainer = Trainer(config.load_cfg(opts=opts), mode="train", device="cpu")
    trainer.train()
    assert "[visualizer] skipped: RuntimeError: panel writer down" in capsys.readouterr().out
    assert (tmp_path / "out" / "checkpoint_best.pth.tar").exists()
