"""Fused Gaussian-noise degrade: CUDA kernel (``csrc/noise.cu``) and its
plain PyTorch version.

Counterpart of ``multi_degradation_image_enhancement_tpu/ops/pallas/noise.py``:

    out = floor(clip(x + σ_b·n, 0, 255)) · scale,   n ~ N(0, 1) by Box–Muller

with both Box–Muller outputs used (element ``p`` gets ``r·cos θ``, element
``p + N/2`` gets ``r·sin θ``; N = H·W·3 per image).  Random bits come from a
counter-based Philox4x32-10 keyed by ``(seed, image index)``; this module also
writes that generator in plain PyTorch, so the CPU path draws exactly the
stream the card draws.

Wrappers (:func:`noise_degrade_01`, :func:`philox_bits`) take the plain
version only for a tensor on the CPU.  For a CUDA tensor they launch the
kernel or raise.  :func:`noise_degrade_01` counts its kernel launches in
``noise_degrade_01.launches``; :func:`philox_bits` is a test hook and is not
counted.
"""

from __future__ import annotations

import torch

from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build

_TWO_PI = 6.283185307179586
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

SIGMA_RANGE = (10.0, 50.0)  # reference range, generate_paired...py:107-122


# --------------------------------------------------------------- plain Philox


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of ``a·m`` for ``a`` in [0, 2³²) held in int64.

    ``m`` is split in 16-bit halves so no partial product leaves int64."""
    t = a * (m & 0xFFFF)
    u = a * (m >> 16)
    s = ((u & 0xFFFF) << 16) + t
    return (u >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 words (broadcasting)."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 → the same bits as int32."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def philox_bits_plain(seed: int, batch: int, n_pairs: int, device="cpu"):
    """The kernel's random words: ``(bits1, bits2)``, int32 ``[batch, n_pairs]``.

    Counter ``q = p // 2`` feeds pair ``p``: words (x, y) for even ``p``,
    (z, w) for odd ``p``; key = (seed, image index)."""
    n_ctr = (n_pairs + 1) // 2
    q = torch.arange(n_ctr, dtype=torch.int64, device=device)[None, :]
    img = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros_like(q)
    x, y, z, w = philox4x32_10(q & _MASK32, q >> 32, zero, zero, seed & _MASK32, img)
    bits1 = torch.stack([x, z], dim=-1).reshape(batch, 2 * n_ctr)[:, :n_pairs]
    bits2 = torch.stack([y, w], dim=-1).reshape(batch, 2 * n_ctr)[:, :n_pairs]
    return _as_int32(bits1), _as_int32(bits2)


# ------------------------------------------------------------ plain Box–Muller


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words → f32 uniform in [0, 1): top 23 bits as the mantissa of a
    float in [1, 2), minus 1 (``noise.py:50-54``).  Takes int32 (or any
    integer dtype holding the word's low 32 bits)."""
    mant = ((bits.to(torch.int32) >> 9) & 0x7FFFFF) | 0x3F800000
    return mant.view(torch.float32) - 1.0


def bits_to_noise01(
    bits1: torch.Tensor, bits2: torch.Tensor, x: torch.Tensor, std: torch.Tensor, scale: float
) -> torch.Tensor:
    """The kernel's math on given bits (counterpart of ``_bits_to_noise01``).

    bits1/bits2: int32 ``[B, N/2]``; x: f32 ``[B, ...]`` in 0..255 with N
    elements per image; std: f32 ``[B]``.  Returns
    ``floor(clip(x + σ·n, 0, 255))·scale`` in f32, shaped like ``x``.
    """
    b = x.shape[0]
    u1 = 1.0 - bits_to_uniform(bits1)  # (0, 1]: safe for log
    u2 = bits_to_uniform(bits2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    n = torch.cat([r * torch.cos(theta), r * torch.sin(theta)], dim=1)
    noised = x.reshape(b, -1) + std.reshape(b, 1) * n
    return (torch.floor(torch.clamp(noised, 0.0, 255.0)) * scale).reshape(x.shape)


def noise_degrade_01_plain(
    images: torch.Tensor, std: torch.Tensor, seed: int, *, scale: float = 1.0 / 255.0,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the whole kernel: Philox bits + Box–Muller."""
    b = images.shape[0]
    bits1, bits2 = philox_bits_plain(seed, b, images[0].numel() // 2, images.device)
    return bits_to_noise01(bits1, bits2, images, std, scale).to(out_dtype)


# ------------------------------------------------------------------ wrappers


def _check_images(images: torch.Tensor) -> None:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected NHWC [B,H,W,3] images, got {tuple(images.shape)}")
    if images[0].numel() % 2:
        raise ValueError("H·W·3 must be even (Box–Muller pairs)")


def noise_degrade_01(
    images: torch.Tensor, std: torch.Tensor, seed: int, *, scale: float = 1.0 / 255.0,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Fused noise degrade: ``floor(clip(images + σ·n, 0, 255))·scale``.

    images: f32 ``[B,H,W,3]`` in 0..255; std: f32 ``[B]``; seed: int (its low
    32 bits key the stream); out_dtype: float32 or bfloat16.
    """
    _check_images(images)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if images.device.type == "cpu":
        return noise_degrade_01_plain(images, std, seed, scale=scale, out_dtype=out_dtype)
    b = images.shape[0]
    _build.require_batch(b, "noise_degrade")
    _build.require(images, "images", torch.float32)
    _build.require(std, "std", torch.float32, (b,))
    out = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    lib = _build.load()
    with _build.on_device(images):
        err = lib.mdie_noise_degrade(
            images.data_ptr(), std.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
            b, images[0].numel(), seed & _MASK32, scale, _build.stream_of(images),
        )
    _build.check(err, "noise_degrade")
    noise_degrade_01.launches += 1
    return out


noise_degrade_01.launches = 0


def philox_bits(seed: int, batch: int, n_pairs: int, device="cpu"):
    """The degrade kernel's random words, ``(bits1, bits2)`` int32
    ``[batch, n_pairs]``, from the kernel's own device function on a CUDA
    device; the plain Philox on the CPU.  Not counted as a launch."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_bits_plain(seed, batch, n_pairs, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    _build.require_batch(batch, "philox_bits")
    bits1 = torch.empty((batch, n_pairs), dtype=torch.int32, device=device)
    bits2 = torch.empty_like(bits1)
    lib = _build.load()
    with _build.on_device(bits1):
        err = lib.mdie_philox_bits(
            bits1.data_ptr(), bits2.data_ptr(), batch, n_pairs, seed & _MASK32,
            _build.stream_of(bits1),
        )
    _build.check(err, "philox_bits")
    return bits1, bits2


def sample_sigma(generator: torch.Generator, batch: int) -> torch.Tensor:
    """σ ~ U[10, 50] per image (the reference's range), on the generator's device."""
    return torch.empty(batch, device=generator.device).uniform_(*SIGMA_RANGE, generator=generator)


def degrade_noise_batch_fast(
    images: torch.Tensor, generator: torch.Generator, *, out_dtype=torch.float32
):
    """Serving-path noise degrade (counterpart of ``degrade_noise_batch_fast``,
    ``noise.py:139-147``): σ and the seed from ``generator``, normals from the
    kernel's Philox stream.  Returns ``(degraded01, clean01)``.  A CPU
    generator keeps the draw off the device (no synchronisation)."""
    std = sample_sigma(generator, images.shape[0]).to(images.device)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device))
    degraded = noise_degrade_01(images, std, seed, out_dtype=out_dtype)
    return degraded, images / 255.0
