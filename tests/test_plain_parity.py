"""Plain-path parity with the reference oracles over awkward frame shapes.

The flagship and DctQim codecs run one plain jnp/lax program on every
device; these pin it to the per-block reference implementations
(tests/oracle.py, tests/oracle_dct.py) at widths whose block counts are
not multiples of 128, 8K-class widths at short heights, padded widths with
prime block counts, and heights whose tail rows must pass through unmarked.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from vfp_tpu.fingerprint import payload_for_segment
from vfp_tpu.ops.soa import rank1_update_soa, top_triplet_soa
from vfp_tpu.wm import DctQim, DeShuffler, DwtDctSvd, Shuffler
from vfp_tpu.wm.dwt_dct_svd import block_grid

import oracle
import oracle_dct
from test_dwt_dct_svd import natural_frames

PAYLOAD = payload_for_segment(1, 2)
SCALE = 15.0

# (H, W): 1080p-class block grid slice, H-tail rows, odd dims, a prime LL
# block count (W=856 -> 107 block columns), a block count that is not a
# multiple of 128 (W=136), and the 5K/8K-class widths at short heights
FLAGSHIP_SHAPES = [(72, 128), (78, 128), (50, 70), (40, 856), (64, 136),
                   (16, 5128), (16, 7680)]
DCT_SHAPES = [(64, 96), (40, 856), (72, 136), (16, 5128)]


def _deg():
    return DeShuffler(key=0, threshold="fixed").set_shape(PAYLOAD.shape)


def _wm(codec, shape):
    return np.asarray(Shuffler(key=0).generate_wm(PAYLOAD, codec.wm_capacity(shape)),
                      np.float32).reshape(-1)


@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES)
def test_flagship_mark_matches_oracle(rng, shape):
    """Our marked frame vs the reference's per-block DCT+SVD embed: equal
    except where a borderline s0 lands in a parity-equivalent QIM bin, and
    the payload decodes on our path and on the reference's."""
    codec = DwtDctSvd()
    frame = natural_frames(rng, b=1, h=shape[0], w=shape[1])[0]
    wm = _wm(codec, frame.shape)
    got = np.asarray(codec.mark_frames(jnp.asarray(frame[None]), jnp.asarray(wm)))[0]
    want = oracle.mark_frame_u8(frame, wm.astype(np.float64))
    assert got.shape == frame.shape
    assert (got == want).mean() > 0.98
    bits = codec.extract_frames(jnp.asarray(got[None]))
    np.testing.assert_array_equal(np.asarray(_deg().degenerate_batch(bits))[0], PAYLOAD)
    np.testing.assert_array_equal(_deg().degenerate(oracle.extract_frame_u8(got)), PAYLOAD)


@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES)
def test_flagship_extract_matches_oracle(rng, shape):
    """Frames marked by the reference decode on our path to the same bits."""
    codec = DwtDctSvd()
    frame = natural_frames(rng, b=1, h=shape[0], w=shape[1])[0]
    wm = _wm(codec, frame.shape)
    marked = oracle.mark_frame_u8(frame, wm.astype(np.float64))
    bits = np.asarray(codec.extract_frames(jnp.asarray(marked[None])))[0]
    (nbh, nbw), cap = block_grid(shape)
    assert bits.shape == (cap,)
    want = oracle.extract_frame_u8(marked)
    assert np.mean(bits[: nbh * nbw] == want[: nbh * nbw]) > 0.99
    assert not bits[nbh * nbw:].any()  # capacity padding decodes as 0
    np.testing.assert_array_equal(_deg().degenerate(bits), PAYLOAD)


@pytest.mark.parametrize("shape", [(78, 128), (50, 70)])
def test_h_tail_rows_pass_through_unmarked(rng, shape):
    """Rows below the last whole LL block row carry no QIM delta: they are
    the reference's color round-trip of the input, pixel for pixel."""
    codec = DwtDctSvd()
    frame = natural_frames(rng, b=1, h=shape[0], w=shape[1])[0]
    (nbh, _), _ = block_grid(shape)
    assert 8 * nbh < shape[0]
    got = np.asarray(codec.mark_frames(jnp.asarray(frame[None]),
                                       jnp.asarray(_wm(codec, frame.shape))))[0]
    yuv = cv2.cvtColor(frame.astype(np.float32), cv2.COLOR_BGR2YUV)
    roundtrip = np.around(np.clip(cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR), 0, 255))
    np.testing.assert_array_equal(got[8 * nbh:], roundtrip[8 * nbh:].astype(np.uint8))


@pytest.mark.parametrize("n", [1, 511, 513, 700, 1000])
def test_block_stage_any_block_count(rng, n):
    """SoA block stage at block counts that are not multiples of 128: the
    dominant singular value matches LAPACK, and a QIM embed decodes back."""
    m = jnp.asarray(rng.rand(1, 16, n).astype(np.float32) * 300)
    s0, u, v = top_triplet_soa(m)
    want = np.linalg.svd(np.asarray(m)[0].T.reshape(n, 4, 4), compute_uv=False)[:, 0]
    np.testing.assert_allclose(np.asarray(s0)[0], want, rtol=1e-4)
    wm = jnp.asarray(rng.randint(0, 2, n).astype(np.float32))
    s_new = (jnp.floor(s0 / SCALE) + 0.25 + 0.5 * wm[None]) * SCALE
    marked = rank1_update_soa(m, s_new - s0, u, v)
    s1, _, _ = top_triplet_soa(marked)
    bits = np.asarray((jnp.mod(s1, SCALE) > SCALE * 0.5).astype(jnp.float32))[0]
    np.testing.assert_array_equal(bits, np.asarray(wm))


def test_zero_blocks_embed_and_decode():
    """All-zero blocks: the triplet falls back to unit vectors, the embed
    stays finite, and every block decodes the embedded bit."""
    m = jnp.zeros((1, 16, 512), jnp.float32)
    s0, u, v = top_triplet_soa(m)
    assert not np.asarray(s0).any()
    s_new = (jnp.floor(s0 / SCALE) + 0.25 + 0.5) * SCALE
    out = rank1_update_soa(m, s_new - s0, u, v)
    assert np.all(np.isfinite(np.asarray(out)))
    s1, _, _ = top_triplet_soa(out)
    bits = np.asarray(jnp.mod(s1, SCALE) > SCALE * 0.5)
    assert bits.all()


@pytest.mark.parametrize("shape", DCT_SHAPES)
def test_dctqim_encode_matches_oracle(rng, shape):
    codec = DctQim()
    frame = natural_frames(rng, b=1, h=shape[0], w=shape[1])[0]
    yuv = cv2.cvtColor(frame.astype(np.float32), cv2.COLOR_BGR2YUV)
    wm = _wm(codec, frame.shape)
    want = oracle_dct.encode_yuv_np(yuv, wm)
    got = np.asarray(codec.encode_yuv(jnp.asarray(yuv[None]), jnp.asarray(wm)))[0]
    np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.mark.parametrize("shape", DCT_SHAPES)
def test_dctqim_extract_matches_oracle(rng, shape):
    codec = DctQim()
    frame = natural_frames(rng, b=1, h=shape[0], w=shape[1])[0]
    yuv = cv2.cvtColor(frame.astype(np.float32), cv2.COLOR_BGR2YUV)
    wm = _wm(codec, frame.shape)
    marked_yuv = oracle_dct.encode_yuv_np(yuv, wm)
    marked = np.around(np.clip(cv2.cvtColor(marked_yuv, cv2.COLOR_YUV2BGR), 0, 255))
    marked = marked.astype(np.uint8)
    bits = np.asarray(codec.extract_frames(jnp.asarray(marked[None])))[0]
    want = oracle_dct.decode_yuv_np(
        cv2.cvtColor(marked.astype(np.float32), cv2.COLOR_BGR2YUV))
    assert np.mean(bits == want) > 0.99
    np.testing.assert_array_equal(_deg().degenerate(bits), PAYLOAD)
