"""2-bit genotype decode on tensors (port of ``janusx_tpu/ops/decode.py``).

The packed dosage-code buffer (``io.bitcodec`` conventions: 0/1/2 =
dosage, 3 = missing, tail padded with 3) stays 16x smaller than f32 on the
device; these ops expand it to centered / standardized f32 blocks right
before the consuming matmul. The hot path decodes inside the hand-written
rotation kernel instead (``ops.kernels.decode_rotate``); these are its
plain-PyTorch building blocks and the GRM's decode.

Pad-and-mask convention: code 3 (missing or padding) decodes to exactly
0.0 in the centered/standardized forms, so sample-axis reductions need no
masking. Arithmetic is exact, so the outputs are bit-identical to the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch

from janusx_tpu_torch import config


def pad_packed_cols(packed: np.ndarray, lane_align: int = config.SAMPLE_ALIGN) -> np.ndarray:
    """Pad packed byte columns so the decoded width is a lane multiple.

    Pad bytes are 0xFF (four code-3 entries = missing = decodes to 0).
    """
    nb = packed.shape[-1]
    byte_align = max(lane_align // 4, 1)
    nb_pad = -(-nb // byte_align) * byte_align
    if nb_pad == nb:
        return packed
    pad = np.full(packed.shape[:-1] + (nb_pad - nb,), 0xFF, dtype=np.uint8)
    return np.concatenate([packed, pad], axis=-1)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """(B, nb) uint8 packed -> (B, 4*nb) uint8 codes (0,1,2,3); sample
    4b+s sits in bits 2s..2s+1 of byte b."""
    shifts = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
    codes = (packed.unsqueeze(-1) >> shifts) & 3
    return codes.reshape(*packed.shape[:-1], packed.shape[-1] * 4)


def decode_centered(packed: torch.Tensor, mean: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Decode to mean-centered values; missing (and padding) -> 0.0.

    packed: (B, nb) uint8; mean: (B,) per-SNP mean dosage.
    Returns (B, 4*nb) ``dtype``."""
    codes = unpack_codes(packed)
    x = codes.to(dtype) - mean.to(dtype).unsqueeze(-1)
    return torch.where(codes == 3, torch.zeros((), dtype=dtype, device=x.device), x)


def decode_standardized(packed: torch.Tensor, mean: torch.Tensor,
                        inv_sd: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Centered then scaled by per-SNP 1/sd; missing/padding -> 0.0."""
    return decode_centered(packed, mean, dtype) * inv_sd.to(dtype).unsqueeze(-1)


def decode_dominance(packed: torch.Tensor, het_freq: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """Centered heterozygosity indicator: het -> 1-hf, hom -> -hf,
    missing/padding -> 0."""
    codes = unpack_codes(packed)
    hf = het_freq.to(dtype).unsqueeze(-1)
    h = torch.where(codes == 1, 1.0 - hf, -hf).to(dtype)
    return torch.where(codes == 3, torch.zeros((), dtype=dtype, device=h.device), h)


def decode_dosage(packed: torch.Tensor, mean: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Raw dosage with mean imputation for missing; padding lanes decode
    to the mean (callers relying on zero padding use the centered forms)."""
    codes = unpack_codes(packed)
    return torch.where(codes == 3, mean.to(dtype).unsqueeze(-1), codes.to(dtype))
