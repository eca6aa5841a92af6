"""Roundtrip + oracle-parity tests for the flagship DwtDctSvd codec."""

import cv2
import numpy as np
import jax
import jax.numpy as jnp

from vfp_tpu.wm import DwtDctSvd, Shuffler, DeShuffler

import oracle

PAYLOAD = np.array([0, 1, 1, 0, 0, 1, 0, 1])


def _frames(rng, b=2, h=64, w=96):
    return rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)


class TestRoundtrip:
    def test_yuv_roundtrip_bits(self, rng):
        codec = DwtDctSvd()
        h, w = 64, 96
        cap = codec.wm_capacity((h, w, 3))
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        yuv = jnp.asarray(rng.rand(2, h, w, 3).astype(np.float32) * 255)
        marked = codec.encode_yuv(yuv, jnp.asarray(wm, jnp.float32))
        bits = codec.decode_yuv(marked)
        payload = DeShuffler(key=0).set_shape(PAYLOAD.shape).degenerate_batch(bits)
        for i in range(2):
            np.testing.assert_array_equal(np.asarray(payload[i]), PAYLOAD)

    def test_uint8_roundtrip_bits(self, rng):
        """Through the full uint8 clip/round path (the acceptance bar)."""
        codec = DwtDctSvd()
        frames = _frames(rng)
        cap = codec.wm_capacity(frames.shape[1:])
        wm = jnp.asarray(Shuffler(key=0).generate_wm(PAYLOAD, cap), jnp.float32)
        marked = codec.mark_frames(jnp.asarray(frames), wm)
        bits = codec.extract_frames(marked)
        payload = DeShuffler(key=0).set_shape(PAYLOAD.shape).degenerate_batch(bits)
        for i in range(frames.shape[0]):
            np.testing.assert_array_equal(np.asarray(payload[i]), PAYLOAD)

    def test_odd_sizes(self, rng):
        """Non-multiple-of-8 dims: capacity > real blocks, crop rules apply."""
        codec = DwtDctSvd()
        frames = rng.randint(0, 256, (1, 50, 70, 3)).astype(np.uint8)
        cap = codec.wm_capacity(frames.shape[1:])
        assert cap == (1, 50 * 70 // 64)
        wm = jnp.asarray(Shuffler(key=0).generate_wm(PAYLOAD, cap), jnp.float32)
        marked = codec.mark_frames(jnp.asarray(frames), wm)
        assert marked.shape == frames.shape
        bits = codec.extract_frames(marked)
        assert bits.shape == (1, cap[1])

    def test_jit_and_vmap(self, rng):
        codec = DwtDctSvd()
        frames = _frames(rng, b=3, h=32, w=32)
        cap = codec.wm_capacity(frames.shape[1:])
        wm = jnp.asarray(Shuffler(key=0).generate_wm(PAYLOAD, cap), jnp.float32)
        marked = jax.jit(codec.mark_frames)(jnp.asarray(frames), wm)
        bits = jax.jit(codec.extract_frames)(marked)
        payload = DeShuffler(key=0).set_shape(PAYLOAD.shape).degenerate_batch(bits)
        np.testing.assert_array_equal(np.asarray(payload[0]), PAYLOAD)


class TestOracleParity:
    """The batched codec must interoperate with the reference algorithm."""

    def test_decode_oracle_marked(self, rng):
        """Frames marked by the reference math must decode on the batched path.

        iid-random uint8 frames are the worst case: the marked frame's u8
        round-off perturbs s0 by ~1, leaving some blocks within float noise
        of the QIM decision edge, where the oracle's f64(+DCT) and our
        f32(no-DCT) s0 may land on different sides.  The per-block agreement
        bar therefore needs a sample large enough that a couple of borderline
        blocks can't dominate (48 blocks -> one flip = 0.979); the payload
        equality below is the actual interop guarantee (repetition voting
        absorbs borderline blocks by design, like any real channel noise)."""
        codec = DwtDctSvd()
        frame = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
        cap = codec.wm_capacity(frame.shape)
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap).flatten().astype(np.float64)
        marked = oracle.mark_frame_u8(frame, wm)
        bits = np.asarray(codec.extract_frames(jnp.asarray(marked[None])))[0]
        want_bits = oracle.extract_frame_u8(marked)
        assert np.mean(bits == want_bits) > 0.99
        payload = DeShuffler(key=0).set_shape(PAYLOAD.shape).degenerate(bits)
        np.testing.assert_array_equal(payload, PAYLOAD)

    def test_oracle_decodes_batched_marked(self, rng):
        """Frames marked on the batched path must decode with the reference math."""
        codec = DwtDctSvd()
        frame = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
        cap = codec.wm_capacity(frame.shape)
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        marked = np.asarray(
            codec.mark_frames(jnp.asarray(frame[None]), jnp.asarray(wm, jnp.float32))
        )[0]
        bits = oracle.extract_frame_u8(marked)
        payload = DeShuffler(key=0).set_shape(PAYLOAD.shape).degenerate(bits)
        np.testing.assert_array_equal(payload, PAYLOAD)

    def test_marked_pixels_close_to_oracle(self, rng):
        codec = DwtDctSvd()
        frame = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
        cap = codec.wm_capacity(frame.shape)
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        ours = np.asarray(
            codec.mark_frames(jnp.asarray(frame[None]), jnp.asarray(wm, jnp.float32))
        )[0].astype(np.int32)
        ref = oracle.mark_frame_u8(frame, wm.flatten().astype(np.float64)).astype(np.int32)
        # identical up to +-1 quantization on a tiny fraction of pixels
        assert np.mean(np.abs(ours - ref) <= 1) == 1.0
        assert np.mean(ours == ref) > 0.95


def natural_frames(rng, b=6, h=96, w=128):
    """Natural-like frames: smooth blobs + mild grain (compressible content)."""
    out = []
    for _ in range(b):
        f = rng.rand(h, w, 3).astype(np.float32) * 255
        f = cv2.GaussianBlur(f, (0, 0), 6) + rng.rand(h, w, 3).astype(np.float32) * 12
        out.append(np.clip(f, 0, 255).astype(np.uint8))
    return np.stack(out)


class TestRobustness:
    def test_survives_jpeg(self, rng):
        """Payload recovery after JPEG q90 re-encode (DCT quantization +
        4:2:0 chroma subsampling — the same attack family as H.264 intra).

        Mirrors the reference's durability bar: >= 75% of frames preserved
        (reference: tests/segment_mark_detect_hls.py:500).
        """
        codec = DwtDctSvd()
        frames = natural_frames(rng)
        cap = codec.wm_capacity(frames.shape[1:])
        wm = jnp.asarray(Shuffler(key=0).generate_wm(PAYLOAD, cap), jnp.float32)
        marked = np.asarray(codec.mark_frames(jnp.asarray(frames), wm))
        deg = DeShuffler(key=0).set_shape(PAYLOAD.shape)
        ok = 0
        for f in marked:
            _, enc = cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 90])
            dec = cv2.imdecode(enc, cv2.IMREAD_COLOR)
            bits = np.asarray(codec.extract_frames(jnp.asarray(dec[None])))[0]
            if np.array_equal(deg.degenerate(bits), PAYLOAD):
                ok += 1
        assert ok >= int(0.75 * len(marked))


class TestMultiChannel:
    def test_custom_scales_roundtrip_and_oracle(self, rng):
        """Non-default scales (two active channels) use the general path."""
        codec = DwtDctSvd(scales=(0.0, 15.0, 9.0))
        frame = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
        cap = codec.wm_capacity(frame.shape)
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        marked = np.asarray(
            codec.mark_frames(jnp.asarray(frame[None]), jnp.asarray(wm, jnp.float32))
        )[0]
        # decoder reads channel 1 regardless of how many channels were marked
        bits = np.asarray(codec.extract_frames(jnp.asarray(marked[None])))[0]
        payload = DeShuffler(key=0).set_shape(PAYLOAD.shape).degenerate(bits)
        np.testing.assert_array_equal(payload, PAYLOAD)
        # oracle with the same scales decodes it too
        ref_bits = oracle.extract_frame_u8(marked, scales=(0, 15, 9))
        ref_payload = DeShuffler(key=0).set_shape(PAYLOAD.shape).degenerate(ref_bits)
        np.testing.assert_array_equal(ref_payload, PAYLOAD)


class TestShapeFuzz:
    def test_many_shapes_roundtrip(self, rng):
        """Crop/capacity plumbing across awkward shapes (both backends share
        the XLA path on CPU; the fused kernel path is shape-gated)."""
        codec = DwtDctSvd()
        for (h, w) in [(37, 53), (31, 127), (64, 129), (41, 48), (48, 41), (100, 100)]:
            frames = rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8)
            cap = codec.wm_capacity((h, w, 3))
            if cap[1] < 8:
                continue
            wm = jnp.asarray(Shuffler(key=0).generate_wm(PAYLOAD, cap), jnp.float32)
            marked = codec.mark_frames(jnp.asarray(frames), wm)
            assert marked.shape == frames.shape, (h, w)
            bits = codec.extract_frames(marked)
            assert bits.shape == (1, cap[1]), (h, w)
            rec = DeShuffler(key=0, threshold="fixed").set_shape(PAYLOAD.shape).degenerate(
                np.asarray(bits)[0]
            )
            np.testing.assert_array_equal(rec, PAYLOAD, err_msg=f"{h}x{w}")
