"""PyTorch port: the plain versions of the probe kernels #11–#14 against the
JAX probes' own kernel bodies.

Each body (``_mm_kernel``, ``kernel_rhsT``, ``kernel_lhsT``, ``kernel_jnpT``)
runs through ``pl.pallas_call(..., interpret=True)`` with BlockSpecs built
here, at small shapes, on the same NumPy inputs as the port.  The int8
GEMM's layout (b turned K-major by a first pass, 128×128 tiles, K steps of
128 in 8-bit ``wgmma`` products of K = 32) is emulated in int64.  On the CPU the
port's wrappers take their plain versions (the CUDA kernels are held against
those on the card by chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks.exp_int8_reprobe import _mm_kernel
from benchmarks.exp_io_transpose import kernel_jnpT, kernel_lhsT, kernel_rhsT
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.probe_matmul import (
    INT8_MMA_K,
    INT8_TILE,
    kmajor_b,
    launch_error,
    probe_matmul,
    probe_matmul_plain,
)
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.probe_transpose import (
    m_dot_xt,
    product_launch_error,
    transpose,
    xt_dot_m,
)

B, M, K, N, N_BLOCK = 2, 32, 64, 128, 64  # the probe's grid (blocks, N / N_BLOCK), scaled down
P, C = 256, 64


def _jax_mm(a, b, acc_dtype, out_dtype):
    call = pl.pallas_call(
        functools.partial(_mm_kernel, acc_dtype=acc_dtype),
        grid=(B, N // N_BLOCK),
        in_specs=[pl.BlockSpec((1, M, K), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((1, K, N_BLOCK), lambda i, j: (i, 0, j))],
        out_specs=pl.BlockSpec((1, M, N_BLOCK), lambda i, j: (i, 0, j)),
        out_shape=jax.ShapeDtypeStruct((B, M, N), out_dtype),
        interpret=True,
    )
    return np.asarray(call(a, b).astype(jnp.float32) if out_dtype == jnp.bfloat16 else call(a, b))


def test_int8_matmul_is_exact():
    rng = np.random.RandomState(0)
    a = rng.randint(-128, 128, (B, M, K)).astype(np.int8)
    b = rng.randint(-128, 128, (B, K, N)).astype(np.int8)
    want = _jax_mm(jnp.asarray(a), jnp.asarray(b), jnp.int32, jnp.int32)
    got = probe_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the extremes: |sum| reaches K * 128^2 and stays exact
    a[:] = -128
    b[:] = -128
    got = probe_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (got == K * 128 * 128).all()


def test_bf16_matmul_within_two_ulp():
    """Positive operands (no output cancels): f32 accumulation in another
    order, one bf16 rounding each side, so at most one bf16 ulp apart; the
    bound is two ulp relative (2 * 2**-7)."""
    rng = np.random.RandomState(1)
    a = jnp.asarray(rng.rand(B, M, K).astype(np.float32), jnp.bfloat16)
    b = jnp.asarray(rng.rand(B, K, N).astype(np.float32), jnp.bfloat16)
    want = _jax_mm(a, b, jnp.float32, jnp.bfloat16)
    ta = torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
    tb = torch.from_numpy(np.asarray(b.astype(jnp.float32))).to(torch.bfloat16)
    got = probe_matmul(ta, tb)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, M, N)
    assert (np.abs(got.float().numpy() - want) <= 2 * 2.0**-7 * np.abs(want)).all()


def _jax_product(kernel, x, m, in_block, out_block, out_shape):
    return pl.pallas_call(
        kernel, grid=(B,),
        in_specs=[pl.BlockSpec(in_block, lambda i: (i, 0, 0)), pl.BlockSpec((C, C), lambda i: (0, 0))],
        out_specs=pl.BlockSpec(out_block, lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.bfloat16), interpret=True,
    )(x, m)


def _bf16_pair(arr):
    """The same bf16 values as a JAX and a torch array."""
    j = jnp.asarray(arr, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("p", [P, 200])  # 200: a multiple of 8, not of the kernels' 128-pixel tile
@pytest.mark.parametrize("route", ["rhsT", "lhsT"])
@pytest.mark.parametrize("m_kind", ["identity", "random"])
def test_products_match_probe_bodies(route, m_kind, p):
    """``M · xᵀ`` and ``xᵀ · M``: with M = I a transpose, bit for bit; with a
    seeded random M (U(-1, 1)) within one bf16 ulp of the largest output
    (2**-7 * max|o|): f32 sums in another order may move one rounding."""
    rng = np.random.RandomState(2)
    m = np.eye(C, dtype=np.float32) if m_kind == "identity" else rng.uniform(-1, 1, (C, C))
    jm, tm = _bf16_pair(m)
    if route == "rhsT":
        jx, tx = _bf16_pair(rng.rand(B, p, C))
        want = _jax_product(kernel_rhsT, jx, jm, (1, p, C), (1, C, p), (B, C, p))
        got = m_dot_xt(tx, tm)
    else:
        jx, tx = _bf16_pair(rng.rand(B, C, p))
        want = _jax_product(kernel_lhsT, jx, jm, (1, C, p), (1, p, C), (B, p, C))
        got = xt_dot_m(tx, tm)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    if m_kind == "identity":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.swapaxes(np.asarray(jx.astype(jnp.float32)), 1, 2))
    else:
        assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()


def test_transpose_matches_probe_body():
    """The probe's own input (``arange·1e-4`` in bf16), bit for bit."""
    x = jnp.arange(B * P * C, dtype=jnp.int32).astype(jnp.bfloat16).reshape(B, P, C) * 1e-4
    want = pl.pallas_call(
        kernel_jnpT, grid=(B,), in_specs=[pl.BlockSpec((1, P, C), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, C, P), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, C, P), jnp.bfloat16), interpret=True,
    )(x)
    got = transpose(torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="bfloat16 or int8"):
        probe_matmul(torch.zeros(1, 4, 4), torch.zeros(1, 4, 4))
    with pytest.raises(ValueError, match=r"\[batch, M, K\]"):
        probe_matmul(torch.zeros(1, 4, 4, dtype=torch.int8), torch.zeros(1, 8, 4, dtype=torch.int8))
    with pytest.raises(ValueError, match="do not fit"):
        m_dot_xt(torch.zeros(1, 8, 32, dtype=torch.bfloat16), torch.eye(64, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        transpose(torch.zeros(1, 4, 4))
    # Only a CPU tensor takes the plain version: any other (a meta tensor
    # here, no card needed) goes to the kernel's checks and is refused.
    eye = torch.eye(64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="multiple of 8"):
        m_dot_xt(torch.empty(1, 100, 64, dtype=torch.bfloat16, device="meta"), eye)
    with pytest.raises(ValueError, match="multiple of 8"):
        xt_dot_m(torch.empty(1, 64, 100, dtype=torch.bfloat16, device="meta"), eye)
    with pytest.raises(ValueError, match="CUDA tensor"):
        xt_dot_m(torch.empty(1, 64, 200, dtype=torch.bfloat16, device="meta"), eye)


def test_matmul_launch_predicate():
    """What #11's two kernels take: bf16 (TMA-fed ``wgmma``) any M, K and N
    multiples of 8 (the maps' 16-byte row strides; ragged tiles read zeros
    and clip their stores); int8 (``mma.sync``) M and N multiples of 128, K
    of 32, at most 65535 batch entries (the grid's z)."""
    bf16, i8 = torch.bfloat16, torch.int8
    assert launch_error(bf16, 32, 1536, 512, 2048) is None  # the probe's shape
    assert launch_error(bf16, 3, 256, 96, 384) is None
    assert launch_error(bf16, 2, 200, 40, 72) is None
    assert "multiples of 8" in launch_error(bf16, 1, 64, 36, 64)
    assert "multiples of 8" in launch_error(bf16, 1, 64, 64, 60)
    assert launch_error(i8, 32, 1536, 512, 2048) is None
    assert launch_error(i8, 3, 256, 96, 384) is None
    assert "multiples of 128" in launch_error(i8, 2, 200, 64, 128)
    assert "multiples of 128" in launch_error(i8, 2, 128, 48, 128)
    assert "batch" in launch_error(i8, 65536, 128, 32, 128)
    assert "empty" in launch_error(bf16, 0, 128, 32, 128)


@pytest.mark.parametrize("batch, p, why", [
    (128, 16384, None),      # the probe's shape
    (3, 1000, None),         # a ragged last tile (1000 = 7 * 128 + 104)
    (5, 40, None),           # one tile, its second 64-pixel half wholly past P
    (65536, 8, None),        # above the 65535 grid cap: the persistent grid has none
    (2, 100, "multiple of 8"),
    (2, 1004, "multiple of 8"),
    (0, 256, "empty"),
    (2, 0, "empty"),
])
def test_product_launch_predicate(batch, p, why):
    """What #12's and #13's kernels take: any batch and any P that is a
    multiple of 8 (the TMA maps' 16-byte row strides along P; a ragged last
    tile reads zeros and clips its store)."""
    got = product_launch_error(batch, p)
    if why is None:
        assert got is None
    else:
        assert why in got


def test_kmajor_b_is_the_transpose():
    """The int8 kernel's first pass turns b ``[batch, K, N]`` into a K-major
    ``[batch, N, K]`` scratch: its plain counterpart is ``b.transpose(1, 2)``,
    contiguous, value for value."""
    rng = np.random.RandomState(5)
    b = torch.from_numpy(rng.randint(-128, 128, (3, 96, 256)).astype(np.int8))
    bt = kmajor_b(b)
    assert bt.shape == (3, 256, 96) and bt.dtype == torch.int8 and bt.is_contiguous()
    assert torch.equal(bt, b.transpose(1, 2))
    assert bt[2, 255, 95] == b[2, 95, 255] and bt[1, 7, 3] == b[1, 3, 7]


def _emulate_int8_gemm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The int8 kernel's arithmetic in its layout, in int64: bt = b turned
    K-major; per 128×128 output tile, K steps of 128 (zeros past K, as the
    TMA map reads them), each four products of K = 32 into the tile's sums."""
    bsz, m, k = a.shape
    n = b.shape[2]
    k_pad = -(-k // INT8_TILE) * INT8_TILE
    a64 = np.zeros((bsz, m, k_pad), np.int64)
    a64[..., :k] = a
    bt = np.zeros((bsz, n, k_pad), np.int64)
    bt[..., :k] = kmajor_b(torch.from_numpy(b)).numpy()
    out = np.zeros((bsz, m, n), np.int64)
    for z in range(bsz):
        for m0 in range(0, m, INT8_TILE):
            for n0 in range(0, n, INT8_TILE):
                acc = np.zeros((INT8_TILE, INT8_TILE), np.int64)
                for kb in range(0, k_pad, INT8_TILE):
                    for kk in range(kb, kb + INT8_TILE, INT8_MMA_K):
                        acc += (a64[z, m0:m0 + INT8_TILE, kk:kk + INT8_MMA_K]
                                @ bt[z, n0:n0 + INT8_TILE, kk:kk + INT8_MMA_K].T)
                out[z, m0:m0 + INT8_TILE, n0:n0 + INT8_TILE] = acc
    return out


@pytest.mark.parametrize("bsz,m,k,n", [(2, 256, 96, 128), (1, 128, 160, 256)])
def test_int8_tile_gemm_emulation_is_exact(bsz, m, k, n):
    """The emulated tile GEMM (a ragged last K step at K = 96 and 160)
    equals ``probe_matmul_plain`` and the JAX ``_mm_kernel`` in interpret
    mode exactly; the extremes (-128 everywhere) sum to K·2**14."""
    rng = np.random.RandomState(6)
    a = rng.randint(-128, 128, (bsz, m, k)).astype(np.int8)
    b = rng.randint(-128, 128, (bsz, k, n)).astype(np.int8)
    got = _emulate_int8_gemm(a, b)
    plain = probe_matmul_plain(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got, plain.numpy().astype(np.int64))
    want = pl.pallas_call(
        functools.partial(_mm_kernel, acc_dtype=jnp.int32), grid=(bsz, n // INT8_TILE),
        in_specs=[pl.BlockSpec((1, m, k), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((1, k, INT8_TILE), lambda i, j: (i, 0, j))],
        out_specs=pl.BlockSpec((1, m, INT8_TILE), lambda i, j: (i, 0, j)),
        out_shape=jax.ShapeDtypeStruct((bsz, m, n), jnp.int32), interpret=True,
    )(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))
    a[:] = -128
    b[:] = -128
    assert (_emulate_int8_gemm(a, b) == k * 2**14).all()


@pytest.mark.parametrize("batch,m,k,n,why", [
    (32, 1536, 512, 2048, None),   # the probe's shape
    (3, 256, 96, 384, None),       # a ragged last K step of 128
    (1, 128, 32, 128, None),       # one tile, one product of K = 32
    (65535, 128, 32, 128, None),   # the transpose pass's grid cap
    (2, 192, 64, 128, "multiples of 128"),
    (2, 128, 64, 200, "multiples of 128"),
    (2, 128, 80, 128, "of 32"),
    (65536, 128, 32, 128, "batch"),
    (1, 0, 32, 128, "empty"),
])
def test_int8_launch_cases(batch, m, k, n, why):
    """What the int8 kernel takes: M and N multiples of its 128×128 tile, K
    of the transpose pass's 32, at most 65535 batch entries (the pass's
    grid z); anything else is named by ``launch_error`` and raised."""
    got = launch_error(torch.int8, batch, m, k, n)
    if why is None:
        assert got is None
    else:
        assert why in got
