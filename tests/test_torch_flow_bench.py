"""The port of ``tools/flow_bench.py`` on the CPU: the headline line's keys
and host rate at a tiny size, and its frames against the tool's
(``jax.image.resize`` of the same seeded normal field)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from predict_pv_yield_tpu_torch import flow_bench

TOOL_KEYS = {"metric", "value", "unit", "vs_baseline", "host_single_core_pairs_per_sec"}


def test_main_prints_the_tool_line_on_the_cpu(capsys):
    result = flow_bench.main("cpu", frames=3, size=64, runs=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert set(result) == TOOL_KEYS
    assert result["metric"] == "farneback flow pairs/sec (64x64)" and result["unit"] == "frame-pairs/s"
    assert result["value"] > 0 and result["host_single_core_pairs_per_sec"] > 0
    assert result["vs_baseline"] == pytest.approx(
        result["value"] / (8 * result["host_single_core_pairs_per_sec"]), rel=0.05, abs=0.01)


@pytest.mark.parametrize("t,h,w", [(4, 64, 64), (3, 80, 48), (2, 88, 68)])
def test_frames_match_the_tool(t, h, w):
    """tools/flow_bench.py:30-36 (square) and :130-135 (the sweep's h × w)."""
    coarse = np.random.default_rng(0).standard_normal((t, h // 16, w // 16)).astype(np.float32)
    expected = np.asarray(jax.image.resize(jnp.asarray(coarse), (t, h, w), "bilinear") * 60 + 120)
    frames = flow_bench._synth_frames(t, (h, w) if h != w else h)
    assert frames.dtype == np.float32 and frames.shape == (t, h, w)
    np.testing.assert_allclose(frames, expected, atol=1e-3, rtol=0)


def test_sweep_covers_the_tool_points():
    """tools/flow_bench.py:119-126: three pair counts at 256², four frame
    sizes at 49 frames up to the production extent."""
    points = {(p["t"], p["h"], p["w"]) for p in flow_bench.SWEEP}
    assert points == {(49, 256, 256), (97, 256, 256), (193, 256, 256), (49, 128, 128),
                      (49, 512, 512), (49, 704, 548)}
