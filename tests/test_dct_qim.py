"""DCT-QIM perceptual codec: oracle parity + roundtrip tests."""

import numpy as np
import cv2
import jax.numpy as jnp

from vfp_tpu.wm import Shuffler, DeShuffler
from vfp_tpu.wm.dct_qim import DctQim, luminance_mask, texture_mask
from vfp_tpu.ops.soa import dct_soa, image_to_soa
from vfp_tpu.ops.color import bgr_to_yuv

import oracle_dct
from test_dwt_dct_svd import natural_frames

PAYLOAD = np.array([0, 1, 1, 0, 0, 1, 0, 1])


def _y_channel(rng, h=64, w=96):
    f = natural_frames(rng, b=1, h=h, w=w)[0]
    return cv2.cvtColor(f.astype(np.float32), cv2.COLOR_BGR2YUV)


class TestMasks:
    def test_luminance_mask_matches_oracle(self, rng):
        yuv = _y_channel(rng)
        want = oracle_dct.luminance_mask_np(yuv[:, :, 0])
        y = jnp.asarray(yuv[None, :, :, 0])
        dc = dct_soa(image_to_soa(y, 8))[:, 0, :]
        got = np.asarray(luminance_mask(dc))[0].reshape(want.shape)
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_texture_mask_matches_oracle(self, rng):
        # use sharp-textured content to hit the edge/ramp branches
        f = (rng.rand(64, 96, 3) * 255).astype(np.uint8)
        yuv = cv2.cvtColor(f.astype(np.float32), cv2.COLOR_BGR2YUV)
        want = oracle_dct.texture_mask_np(yuv[:, :, 0])
        y = jnp.asarray(yuv[None, :, :, 0])
        got = np.asarray(texture_mask(dct_soa(image_to_soa(y, 8))))[0].reshape(want.shape)
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert (want != 1.0).any()  # branches actually exercised

    def test_smooth_content_masks(self, rng):
        yuv = _y_channel(rng)
        want = oracle_dct.texture_mask_np(yuv[:, :, 0]) * oracle_dct.luminance_mask_np(yuv[:, :, 0])
        codec = DctQim()
        got = np.asarray(codec._masks(jnp.asarray(yuv[None, :, :, 0])))[0].reshape(want.shape)
        np.testing.assert_allclose(got, want, atol=1e-4)


class TestCodec:
    def test_encode_matches_oracle(self, rng):
        codec = DctQim()
        frame = natural_frames(rng, b=1, h=64, w=96)[0]
        yuv = cv2.cvtColor(frame.astype(np.float32), cv2.COLOR_BGR2YUV)
        cap = codec.wm_capacity(frame.shape)
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        want = oracle_dct.encode_yuv_np(yuv, np.asarray(wm).flatten())
        got = np.asarray(codec.encode_yuv(jnp.asarray(yuv[None]), jnp.asarray(wm, jnp.float32)))[0]
        np.testing.assert_allclose(got, want, atol=2e-2)

    def test_uint8_roundtrip(self, rng):
        codec = DctQim()
        frames = natural_frames(rng, b=3, h=64, w=96)
        cap = codec.wm_capacity(frames.shape[1:])
        wm = jnp.asarray(Shuffler(key=0).generate_wm(PAYLOAD, cap), jnp.float32)
        marked = codec.mark_frames(jnp.asarray(frames), wm)
        bits = codec.extract_frames(marked)
        deg = DeShuffler(key=0).set_shape(PAYLOAD.shape)
        out = deg.degenerate_batch(bits)
        for i in range(3):
            np.testing.assert_array_equal(np.asarray(out[i]), PAYLOAD)

    def test_oracle_decodes_ours(self, rng):
        codec = DctQim()
        frame = natural_frames(rng, b=1, h=64, w=96)[0]
        cap = codec.wm_capacity(frame.shape)
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        marked = np.asarray(codec.mark_frames(jnp.asarray(frame[None]), jnp.asarray(wm, jnp.float32)))[0]
        yuv = cv2.cvtColor(marked.astype(np.float32), cv2.COLOR_BGR2YUV)
        bits = oracle_dct.decode_yuv_np(yuv)
        out = DeShuffler(key=0).set_shape(PAYLOAD.shape).degenerate(bits)
        np.testing.assert_array_equal(out, PAYLOAD)

    def test_we_decode_oracle(self, rng):
        codec = DctQim()
        frame = natural_frames(rng, b=1, h=64, w=96)[0]
        cap = codec.wm_capacity(frame.shape)
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        yuv = cv2.cvtColor(frame.astype(np.float32), cv2.COLOR_BGR2YUV)
        marked_yuv = oracle_dct.encode_yuv_np(yuv, np.asarray(wm).flatten())
        bgr = cv2.cvtColor(marked_yuv.astype(np.float32), cv2.COLOR_YUV2BGR)
        marked = np.around(np.clip(bgr, 0, 255)).astype(np.uint8)
        bits = np.asarray(codec.extract_frames(jnp.asarray(marked[None])))[0]
        out = DeShuffler(key=0).set_shape(PAYLOAD.shape).degenerate(bits)
        np.testing.assert_array_equal(out, PAYLOAD)
