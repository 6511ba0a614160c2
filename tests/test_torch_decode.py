"""Port parity: janusx_tpu_torch.ops.decode vs janusx_tpu.ops.decode.

The decode is exact arithmetic (small integers minus an f32 mean, times an
f32 scale), so the bound is bit-exact. Inputs cover code 3 (missing) and
a ragged sample tail (n not a multiple of 4, padded with code 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janusx_tpu.io import bitcodec
from janusx_tpu.ops import decode as jdec
from janusx_tpu_torch.ops import decode as tdec


@pytest.fixture(scope="module")
def packed_block():
    rng = np.random.default_rng(11)
    M, n = 37, 203  # ragged rows and a ragged sample tail (203 % 4 == 3)
    codes = rng.integers(0, 3, size=(M, n)).astype(np.uint8)
    codes[rng.random((M, n)) < 0.1] = bitcodec.CODE_MISSING
    packed = bitcodec.pack_codes(codes)  # tail lanes padded with code 3
    mean = rng.uniform(0, 2, M).astype(np.float32)
    inv_sd = rng.uniform(0.5, 3, M).astype(np.float32)
    return packed, mean, inv_sd


def _both(fn, packed, *vecs):
    ref = np.asarray(getattr(jdec, fn)(jnp.asarray(packed),
                                       *(jnp.asarray(v) for v in vecs)))
    port = getattr(tdec, fn)(torch.from_numpy(packed),
                             *(torch.from_numpy(v) for v in vecs)).numpy()
    return ref, port


@pytest.mark.parametrize("fn,nvec", [
    ("decode_centered", 1), ("decode_standardized", 2),
    ("decode_dominance", 1), ("decode_dosage", 1),
])
def test_decode_bit_exact(packed_block, fn, nvec):
    packed, mean, inv_sd = packed_block
    ref, port = _both(fn, packed, *(mean, inv_sd)[:nvec])
    assert port.dtype == np.float32 and port.shape == ref.shape
    np.testing.assert_array_equal(port, ref)


def test_unpack_codes_bit_exact(packed_block):
    packed, _, _ = packed_block
    ref = np.asarray(jdec.unpack_codes(jnp.asarray(packed)))
    port = tdec.unpack_codes(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(port, ref)
    # natural sample order, code 3 on the padded tail
    n = 203
    np.testing.assert_array_equal(port[:, :n], bitcodec.unpack_codes(packed, n))
    assert np.all(port[:, n:] == 3)


def test_missing_and_pad_decode_to_zero(packed_block):
    packed, mean, _ = packed_block
    codes = tdec.unpack_codes(torch.from_numpy(packed)).numpy()
    x = tdec.decode_centered(torch.from_numpy(packed), torch.from_numpy(mean)).numpy()
    assert np.all(x[codes == 3] == 0.0)
    assert np.all(x[codes != 3] == (codes[codes != 3] - np.broadcast_to(
        mean[:, None], codes.shape)[codes != 3]).astype(np.float32))


@pytest.mark.parametrize("lane_align", [4, 128, 512])
def test_pad_packed_cols_matches(packed_block, lane_align):
    packed, _, _ = packed_block
    np.testing.assert_array_equal(tdec.pad_packed_cols(packed, lane_align),
                                  jdec.pad_packed_cols(packed, lane_align))
