"""Port of the separable blur (``ops/pallas_blur.py`` → port ``ops/sep_blur.py``).

The CUDA kernel runs only on a card (``chip_smoke.py`` holds it to the plain
version there). Here the plain version, which a CPU tensor takes, is held to
the JAX package's XLA path and to its Pallas kernel body run by the Pallas
interpreter, on the same numpy inputs.
"""

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from predict_pv_yield_tpu.ops import pallas_blur as pb
from predict_pv_yield_tpu.ops.optical_flow import _gaussian_kernel
from predict_pv_yield_tpu_torch import _build
from predict_pv_yield_tpu_torch.ops import sep_blur as port

# (shape, radius): the Farnebäck window at winsize 40, and a ragged plane
CASES = [((2, 5, 64, 64), 20), ((2, 5, 37, 53), 7)]
# shapes where the kernel's tiling is most likely to go wrong, at winsize
# 40: the production pyramid's ragged level 2, a plane smaller than the
# window, and a plane shorter than one band and wider than the window
EDGE_CASES = [((1, 5, 176, 137), 20), ((1, 5, 16, 16), 20), ((1, 5, 17, 200), 20)]


def _taps(radius, gaussian):
    if gaussian:
        return _gaussian_kernel(radius, radius * 0.3)
    return np.full(2 * radius + 1, 1.0 / (2 * radius + 1), np.float32)


def _pallas_interpreted(fields, kernel, tile):
    """``sep_blur_pallas``'s call with ``interpret=True`` (and no TPU memory
    spaces), as tests/test_pallas_blur.py runs the kernel body."""
    n, c, height, width = fields.shape
    radius = len(kernel) // 2
    channels = n * c
    grid_h = -(-height // tile)
    padded = np.pad(
        fields.reshape(channels, height, width),
        ((0, 0), (radius, radius), (radius, radius)),
        mode="edge",
    )
    rows_needed = (grid_h + 1) * tile
    padded = np.pad(padded, ((0, 0), (0, max(rows_needed - padded.shape[1], 0)), (0, 0)))
    band_x = pb._band_matrix(kernel, width)
    band_y = pb._band_matrix(kernel, tile).T
    block = (channels, tile, padded.shape[2])
    out = pl.pallas_call(
        functools.partial(pb._blur_kernel, tile=tile, radius=radius),
        grid=(grid_h,),
        in_specs=[
            pl.BlockSpec(block, lambda i: (0, i, 0)),
            pl.BlockSpec(block, lambda i: (0, i + 1, 0)),
            pl.BlockSpec(band_x.shape, lambda i: (0, 0)),
            pl.BlockSpec(band_y.shape, lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((channels, tile, width), lambda i: (0, i, 0)),
        out_shape=jax.ShapeDtypeStruct((channels, grid_h * tile, width), jnp.float32),
        interpret=True,
    )(jnp.asarray(padded), jnp.asarray(padded), jnp.asarray(band_x), jnp.asarray(band_y))
    return np.asarray(out)[:, :height].reshape(n, c, height, width)


@pytest.mark.parametrize("gaussian", [True, False], ids=["gaussian", "box"])
@pytest.mark.parametrize(
    "shape,radius",
    CASES + EDGE_CASES,
    ids=["64x64_r20", "37x53_r7", "176x137_r20", "16x16_r20", "17x200_r20"],
)
def test_plain_matches_xla_path(shape, radius, gaussian):
    fields = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    taps = _taps(radius, gaussian)
    expected = np.asarray(pb._sep_blur_xla_batched(jnp.asarray(fields), taps))
    out = port.sep_blur(torch.from_numpy(fields), taps)
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), expected, atol=1e-4)


@pytest.mark.parametrize("gaussian", [True, False], ids=["gaussian", "box"])
@pytest.mark.parametrize("shape,radius", CASES, ids=["64x64_r20", "37x53_r7"])
def test_plain_matches_pallas_kernel_body(shape, radius, gaussian):
    fields = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    taps = _taps(radius, gaussian)
    tile = max(16, 2 * radius)  # the Pallas kernel needs tile >= 2r
    expected = _pallas_interpreted(fields, taps, tile)
    out = port.sep_blur_reference(torch.from_numpy(fields), taps)
    np.testing.assert_allclose(out.numpy(), expected, atol=1e-4)


def test_cpu_tensor_takes_plain_version_without_launch():
    fields = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 5, 16, 16)).astype(np.float32))
    before = port.launches
    out = port.sep_blur(fields, _taps(3, True))
    assert port.launches == before
    torch.testing.assert_close(out, port.sep_blur_reference(fields, _taps(3, True)), rtol=0, atol=0)


class _SlowInt(int):
    """An int whose ``+`` sleeps, which widens the gap between a counter's
    read and its write so that threads interleave inside it."""

    def __add__(self, other):
        time.sleep(1e-3)
        return _SlowInt(int(self) + other)


def _bump_from_threads(bump, n_threads=8, calls=20):
    """``bump`` called ``calls`` times on each of ``n_threads`` threads that
    start together."""
    barrier = threading.Barrier(n_threads)

    def run():
        barrier.wait()
        for _ in range(calls):
            bump()

    threads = [threading.Thread(target=run) for _ in range(n_threads)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
    assert not any(thread.is_alive() for thread in threads)
    return n_threads * calls


def test_launch_counter_is_exact_under_concurrent_threads(monkeypatch):
    """The flow dataset's producer thread and the main thread both launch
    the kernel. With the read and the write of the count held apart, a bare
    read-modify-write loses counts, and ``_count_launch`` loses none."""

    def unlocked():
        port.launches += 1

    monkeypatch.setattr(port, "launches", _SlowInt(0))
    calls = _bump_from_threads(unlocked)
    assert port.launches < calls

    monkeypatch.setattr(port, "launches", _SlowInt(0))
    calls = _bump_from_threads(port._count_launch)
    assert port.launches == calls


@pytest.mark.parametrize(
    "fields,taps,error",
    [
        (torch.zeros((1, 5, 8, 8), dtype=torch.float64), np.ones(3), TypeError),
        (torch.zeros((1, 5, 8, 16)).transpose(2, 3), np.ones(3), ValueError),
        (torch.zeros((5, 8, 8)), np.ones(3), ValueError),
        (torch.zeros((1, 5, 8, 8)), np.ones(4), ValueError),
        (torch.zeros((1, 5, 8, 8)), np.ones(port.MAX_TAPS + 2), ValueError),
    ],
    ids=["fp64", "non_contiguous", "3d", "even_taps", "too_many_taps"],
)
def test_wrapper_rejects(fields, taps, error):
    with pytest.raises(error):
        port.sep_blur(fields, taps)


def test_library_name_follows_headers(tmp_path, monkeypatch):
    """A changed header under csrc/ rebuilds the kernel: it changes the name
    the built library is cached under."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "kernel.cu").write_text('#include "kernel.cuh"\n')
    (tmp_path / "kernel.cuh").write_text("// one\n")
    first = _build.library_path("kernel")
    (tmp_path / "kernel.cuh").write_text("// two\n")
    assert _build.library_path("kernel") != first
    (tmp_path / "kernel.cuh").write_text("// one\n")
    assert _build.library_path("kernel") == first
