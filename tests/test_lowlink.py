"""LL-domain low-link transport parity (pipeline/lowlink.py).

The transport moves float16 LL bands up and int8 fixed-point LL deltas down
instead of full frames; these tests pin (1) host LL == device LL math,
(2) reconstructed marked frames match the full-frame path up to rounding-
boundary pixels with identical payload recovery, and (3) the extractor side
returns the same payloads as the full-frame FrameExtractor.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from vfp_tpu.pipeline import (
    FrameExtractor,
    FrameMarker,
    LowLinkExtractor,
    LowLinkMarker,
    host_ll,
    reconstruct,
)
from vfp_tpu.pipeline.lowlink import lowlink_ok
from vfp_tpu.wm import DeShuffler, DwtDctSvd, Shuffler
from vfp_tpu.fingerprint import payload_for_segment

PAYLOAD = np.array([0, 1, 1, 0, 0, 1, 0, 1])


def natural_frames(rng, b, h, w):
    h8, w8 = -(-h // 8) * 8, -(-w // 8) * 8
    small = rng.rand(b, h8 // 8, w8 // 8, 3)
    f = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2)[:, :h, :w] * 220
    f = f + rng.rand(b, h, w, 3) * 20
    return np.clip(f, 0, 255).astype(np.uint8)


class TestHostLL:
    def test_matches_device_ll(self, rng):
        codec = DwtDctSvd()
        frames = natural_frames(rng, 2, 78, 102)  # odd-ish dims: crop path
        want = np.asarray(codec._ll_from_frames(
            jnp.asarray(np.moveaxis(np.moveaxis(frames, -1, 1), 1, -1)).astype(jnp.float32), 1))
        got = host_ll(frames, 1).astype(np.float32)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=0.13)  # f16 quantization


class TestLowLinkMarker:
    def test_ll_delta2_matches_per_bit(self, rng):
        """_ll_delta2 (one triplet solve, both planes) must equal _ll_delta
        called with all-0 / all-1 bit vectors — bit-exact, same association."""
        import jax.numpy as jnp

        codec = DwtDctSvd()
        ll = jnp.asarray(
            (rng.rand(3, 36, 52).astype(np.float32) * 400 + 50))
        d2 = np.asarray(codec._ll_delta2(ll, 15.0))
        nb = (36 // 4) * (52 // 4)
        for b in (0, 1):
            want = np.asarray(codec._ll_delta(
                ll, jnp.full((nb,), float(b), jnp.float32), 15.0))
            np.testing.assert_array_equal(d2[b], want)

    def test_eligibility(self):
        assert lowlink_ok(DwtDctSvd())
        assert not lowlink_ok(DwtDctSvd(scales=(5.0, 15.0, 0.0)))

    def test_matches_full_frame_path(self, rng):
        codec = DwtDctSvd()
        frames = natural_frames(rng, 4, 64, 96)
        cap = codec.wm_capacity(frames.shape[1:])
        wms = [Shuffler(key=0).generate_wm(payload_for_segment(1, c), cap) for c in range(2)]
        mm = LowLinkMarker(codec, wms, batch_size=4, wire="f16")
        got = mm.mark_all(frames)
        assert got.shape == (2, 4, 64, 96, 3)
        for v in range(2):
            want = np.asarray(codec.mark_frames(
                jnp.asarray(frames), jnp.asarray(np.asarray(wms[v]).reshape(-1), jnp.float32)))
            diff = np.abs(got[v].astype(int) - want.astype(int))
            # +-1 on rounding-boundary pixels (int8/8 delta quantization) and
            # rare parity-equivalent QIM-bin swaps on borderline s0 (f16 LL),
            # exactly like the fused kernel's documented tolerance
            assert (diff <= 1).mean() > 0.999
            assert (diff == 0).mean() > 0.95
            assert diff.max() <= 16
        # payload recovery identical to the full path
        deg = DeShuffler(key=0, threshold="fixed").set_shape((8,))
        for v in range(2):
            bits = np.asarray(codec.extract_frames(jnp.asarray(got[v])))
            for b in bits:
                np.testing.assert_array_equal(
                    deg.degenerate(b), payload_for_segment(1, v))

    def test_partial_batch_and_odd_dims(self, rng):
        codec = DwtDctSvd()
        frames = natural_frames(rng, 3, 78, 102)  # 3 < batch, h/w not %8
        cap = codec.wm_capacity(frames.shape[1:])
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        mm = LowLinkMarker(codec, [wm], batch_size=8)
        got = mm.mark_all(frames)
        assert got.shape == (1, 3, 78, 102, 3)
        # untouched outside the 4-aligned crop and in the R channel
        np.testing.assert_array_equal(got[0][:, 76:], frames[:, 76:])
        np.testing.assert_array_equal(got[0][..., 2], frames[..., 2])

    def test_frame_marker_routes_lowlink(self, rng, monkeypatch):
        monkeypatch.setenv("VFP_LOWLINK", "1")
        codec = DwtDctSvd()
        frames = natural_frames(rng, 2, 64, 96)
        wm = Shuffler(key=0).generate_wm(PAYLOAD, codec.wm_capacity(frames.shape[1:]))
        fm = FrameMarker(codec, wm, batch_size=2)
        assert fm._ll is not None
        marked = fm.mark(frames)
        deg = DeShuffler(key=0, threshold="fixed").set_shape(PAYLOAD.shape)
        bits = np.asarray(codec.extract_frames(jnp.asarray(marked)))
        for b in bits:
            np.testing.assert_array_equal(deg.degenerate(b), PAYLOAD)

    def test_two_plane_matches_per_variant(self, rng):
        """V >= 3 ships bit0/bit1 delta planes + host block-select; must be
        bit-identical to the per-variant device path (int8 quantization is
        elementwise, so select-then-quantize == quantize-then-select)."""
        codec = DwtDctSvd()
        frames = natural_frames(rng, 3, 78, 102)
        cap = codec.wm_capacity(frames.shape[1:])
        wms = [Shuffler(key=0).generate_wm(payload_for_segment(2, c), cap)
               for c in range(3)]
        mm = LowLinkMarker(codec, wms, batch_size=4)
        assert mm._two_plane
        got = mm.mark_all(frames)
        for v in range(3):
            ref = LowLinkMarker(codec, [wms[v]], batch_size=4)
            assert not ref._two_plane
            np.testing.assert_array_equal(got[v], ref.mark_all(frames)[0])

    def test_submit_collect_pipelined(self, rng):
        codec = DwtDctSvd()
        frames = natural_frames(rng, 8, 64, 96)
        cap = codec.wm_capacity(frames.shape[1:])
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        mm = LowLinkMarker(codec, [wm], batch_size=4)
        handles = [mm.submit(frames[:4]), mm.submit(frames[4:])]
        outs = [mm.collect(h) for h in handles]
        direct = mm.mark_all(frames[:4])
        np.testing.assert_array_equal(outs[0], direct)


class TestPackedTwoPlane:
    def test_packed_matches_unpacked_across_segments(self, rng):
        """4 'segments' x 6 frames share packed 16-frame device calls; every
        segment's marked output must be bit-identical to its own unpacked
        two-plane LowLinkMarker.  Collecting the tail before a pack boundary
        forces the power-of-two ladder flush (16 + 8 here => 2 calls for 24
        frames instead of 4)."""
        from vfp_tpu.pipeline.lowlink import PackedTwoPlane

        codec = DwtDctSvd()
        cap = codec.wm_capacity((64, 96, 3))
        segs = [natural_frames(rng, 6, 64, 96) for _ in range(4)]
        wms = [
            [Shuffler(key=0).generate_wm(payload_for_segment(i, c), cap)
             for c in range(3)]
            for i in range(4)
        ]
        packer = PackedTwoPlane(codec, pack=16)
        mms = [LowLinkMarker(codec, w, batch_size=16, packer=packer) for w in wms]
        assert all(m._packer is packer for m in mms)
        handles = [m.submit(f) for m, f in zip(mms, segs)]
        gots = [m.collect(h) for m, h in zip(mms, handles)]
        assert packer.calls == 2  # one full 16-chunk + one forced ladder 8
        for got, w, f in zip(gots, wms, segs):
            want = LowLinkMarker(codec, w, batch_size=16).mark_all(f)
            np.testing.assert_array_equal(got, want)

    def test_dim_change_flushes_chunk(self, rng):
        """A submission with different frame dims must never share a chunk
        with pending pieces of another shape."""
        from vfp_tpu.pipeline.lowlink import PackedTwoPlane

        codec = DwtDctSvd()
        packer = PackedTwoPlane(codec, pack=16)
        a = natural_frames(rng, 5, 64, 96)
        b = natural_frames(rng, 5, 80, 112)
        mk = lambda f: LowLinkMarker(  # noqa: E731
            codec,
            [Shuffler(key=0).generate_wm(payload_for_segment(1, c),
                                         codec.wm_capacity(f.shape[1:]))
             for c in range(3)],
            batch_size=16, packer=packer)
        ma, mb = mk(a), mk(b)
        ha = ma.submit(a)
        hb = mb.submit(b)  # dim change: flushes the pending 64x96 pieces
        got_b = mb.collect(hb)
        got_a = ma.collect(ha)
        for m, f, got in ((ma, a, got_a), (mb, b, got_b)):
            want = LowLinkMarker(codec, [w for w in m._wms_np],
                                 batch_size=16).mark_all(f)
            np.testing.assert_array_equal(got, want)

    def test_explicit_flush_and_single_piece(self, rng):
        from vfp_tpu.pipeline.lowlink import PackedTwoPlane

        codec = DwtDctSvd()
        cap = codec.wm_capacity((64, 96, 3))
        frames = natural_frames(rng, 3, 64, 96)
        wms = [Shuffler(key=0).generate_wm(payload_for_segment(0, c), cap)
               for c in range(3)]
        packer = PackedTwoPlane(codec, pack=16)
        mm = LowLinkMarker(codec, wms, batch_size=16, packer=packer)
        h = mm.submit(frames)
        packer.flush()  # stream end: dispatch the 3-frame tail (ladder 2+1)
        assert packer.calls == 2
        got = mm.collect(h)
        want = LowLinkMarker(codec, wms, batch_size=16).mark_all(frames)
        np.testing.assert_array_equal(got, want)


class TestLowLinkExtractor:
    def test_matches_full_frame_extractor(self, rng):
        codec = DwtDctSvd()
        frames = natural_frames(rng, 5, 64, 96)
        cap = codec.wm_capacity(frames.shape[1:])
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        marked = np.asarray(codec.mark_frames(
            jnp.asarray(frames), jnp.asarray(np.asarray(wm).reshape(-1), jnp.float32)))
        deg = DeShuffler(key=0, threshold="fixed").set_shape(PAYLOAD.shape)
        want = FrameExtractor(codec, deg, batch_size=4).extract(marked)
        got = LowLinkExtractor(codec, deg, batch_size=4, wire="f16").extract(marked)
        np.testing.assert_array_equal(got, want)
        for p in got:
            np.testing.assert_array_equal(p, PAYLOAD)


class TestU8Wire:
    """Dithered u8 LL up-leg (default wire — half the link traffic of f16).

    Three load-bearing pieces: the signed-chroma bias (without it the
    unsigned clip destroys negative U LL — measured 19% raw bit errors),
    the 2x2 subtractive dither (smooth blocks otherwise quantize with
    identical per-entry errors, shifting s0 by 4x the half-step), and the
    collect-time RECENTRING (lowlink.recentre_dll): the device centres s0
    of the QUANTIZED LL, so without correction the marked frame sits
    off-centre by u^T E v — with it, centering matches the f16 wire."""

    def test_mark_and_extract_clean(self, rng):
        codec = DwtDctSvd()
        frames = natural_frames(rng, 4, 64, 96)
        cap = codec.wm_capacity(frames.shape[1:])
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        wmf = np.asarray(wm).reshape(-1)
        mm = LowLinkMarker(codec, [wm], batch_size=4, wire="u8")
        got = mm.mark_all(frames)[0]
        # raw per-block DECISION parity vs the exact full-frame path: the
        # wire+recentring must add zero new bit errors.  (Not vs the wm
        # itself: blocks whose s1 exceeds the bit-0 target 0.25*scale are
        # undecodable by the SCHEME — s1 takes over the decode — and this
        # input has two such blocks; the exact path fails them identically.)
        exact = np.asarray(codec.mark_frames(
            jnp.asarray(frames), jnp.asarray(wmf, jnp.float32)))
        bits = np.asarray(codec.extract_frames(jnp.asarray(got)))
        bits_exact = np.asarray(codec.extract_frames(jnp.asarray(exact)))
        nb = (64 // 8) * (96 // 8)
        np.testing.assert_array_equal(bits[:, :nb], bits_exact[:, :nb])
        # and the scheme's own raw error rate is what it is: tiny
        assert (bits_exact[:, :nb] != wmf[:nb]).mean() < 0.01
        # u8-wire extractor decodes exact-path marked frames
        exact = np.asarray(codec.mark_frames(
            jnp.asarray(frames), jnp.asarray(wmf, jnp.float32)))
        deg = DeShuffler(key=0, threshold="fixed").set_shape(PAYLOAD.shape)
        fx = LowLinkExtractor(codec, deg, batch_size=4, wire="u8")
        for p in fx.extract(exact):
            np.testing.assert_array_equal(p, PAYLOAD)

    def test_u8_centering_matches_f16(self, rng):
        """The durability-relevant property: each marked block's s0 must sit
        as close to its QIM centre under the u8 wire as under f16 — the
        attack margin IS the off-centre distance, so distribution parity
        here implies equal survival through any channel.  (Per-block s0
        EQUALITY is not expected: near a cell edge the two wires may pick
        different — equally valid — centres for the same bit.)  Measured on
        this input: rms off-centre 1.070 (u8) vs 1.075 (f16), both tails
        under the scale/4 = 3.75 margin; the residual is the shared pixel-
        rounding noise, not wire quantization."""
        codec = DwtDctSvd()
        frames = natural_frames(rng, 4, 240, 320)
        cap = codec.wm_capacity(frames.shape[1:])
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        scale = float(codec.scales[1])

        from vfp_tpu.pipeline.lowlink import _host_triplet, active_channel

        chan, blk = active_channel(codec), codec.blk

        def off_centre(marked):
            ll = host_ll(marked, chan).astype(np.float32)
            k, hc, wc = ll.shape
            nbh, nbw = hc // blk, wc // blk
            X = (ll[:, : nbh * blk, : nbw * blk]
                 .reshape(k, nbh, blk, nbw, blk)
                 .transpose(0, 1, 3, 2, 4).reshape(-1, blk, blk))
            s0, _, _ = _host_triplet(X)
            return np.abs((s0 % (scale / 2)) - scale / 4)

        off_u8 = off_centre(
            LowLinkMarker(codec, [wm], batch_size=4, wire="u8").mark_all(frames)[0])
        off_f16 = off_centre(
            LowLinkMarker(codec, [wm], batch_size=4, wire="f16").mark_all(frames)[0])
        rms = lambda x: float(np.sqrt((x ** 2).mean()))
        assert rms(off_u8) <= rms(off_f16) + 0.05, (rms(off_u8), rms(off_f16))
        assert float(np.percentile(off_u8, 99)) <= float(
            np.percentile(off_f16, 99)) + 0.15
        # every block decodes its own bit back: inside the margin
        assert off_u8.max() <= scale / 4 + 1e-3

    def test_flat_chroma_survives_lossy_encode(self, rng):
        """Regression: flat-chroma content (grayscale video: U LL constant
        1.0, the reference fixture clip's exact condition) quantizes to
        ALL-ZERO wire bytes (round-half-even of 0.5), so the device's SVD
        direction was the dither pattern itself — recentring fixed the
        magnitude (clean decode passed) but the delta's energy sat in high
        spatial frequencies, which MJPEG/JPEG chroma quantization wipes:
        measured 2-35% post-encode raw bit errors vs 0% for the exact path.
        The WIRE_DIR_GAMMA2 gate now repairs direction-unreliable blocks
        from the TRUE LL, making the u8-marked frames byte-identical to the
        exact host path on such content — and hence equally durable."""
        import cv2

        codec = DwtDctSvd()
        g = (rng.rand(4, 240, 320, 1) * 30 + 100).astype(np.uint8)
        frames = np.repeat(g, 3, axis=3)  # B=G=R: U LL == 1.0 everywhere
        cap = codec.wm_capacity(frames.shape[1:])
        wms = [jnp.asarray(rng.randint(0, 2, cap), jnp.float32)
               for _ in range(3)]
        m_u8 = LowLinkMarker(codec, wms, batch_size=4, wire="u8")
        m_host = LowLinkMarker(codec, wms, batch_size=4, wire="host")
        got = m_u8.mark_all(frames)
        np.testing.assert_array_equal(got, m_host.mark_all(frames))
        # and the mark survives JPEG-95 (DC-direction delta on flat chroma):
        # the ungated wire measured 2-35% raw bit errors here; the exact
        # path's residual is the odd rounding-borderline block, not a rate
        nb = (240 // 8) * (320 // 8)
        for v in range(3):
            want = np.asarray(wms[v])[:nb]
            errs = []
            for f in got[v]:
                _, enc = cv2.imencode(".jpg", f,
                                      [cv2.IMWRITE_JPEG_QUALITY, 95])
                bits = np.asarray(codec.extract_frames(
                    jnp.asarray(cv2.imdecode(enc, 1)[None])))[0]
                errs.append(float(np.mean(bits[:nb] != want)))
            assert max(errs) < 0.005, errs

    def test_host_wire_decision_parity_and_no_jax(self, rng):
        """wire='host' (the zero-link fallback: numpy twin of the device
        program) — raw decode decisions match the exact full-frame path,
        and the extractor recovers payloads, all without a single device
        dispatch (handle carries a plain ndarray)."""
        codec = DwtDctSvd()
        frames = natural_frames(rng, 4, 96, 128)
        cap = codec.wm_capacity(frames.shape[1:])
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        wmf = np.asarray(wm).reshape(-1)
        mm = LowLinkMarker(codec, [wm], batch_size=4, wire="host")
        h = mm.submit(frames)
        assert isinstance(h[0], np.ndarray)  # no device handle anywhere
        got = mm.collect(h)[0]
        exact = np.asarray(codec.mark_frames(
            jnp.asarray(frames), jnp.asarray(wmf, jnp.float32)))
        bits = np.asarray(codec.extract_frames(jnp.asarray(got)))
        bits_exact = np.asarray(codec.extract_frames(jnp.asarray(exact)))
        nb = (96 // 8) * (128 // 8)
        np.testing.assert_array_equal(bits[:, :nb], bits_exact[:, :nb])
        # host extractor on exact-path marked frames: full payload recovery
        deg = DeShuffler(key=0, threshold="fixed").set_shape(PAYLOAD.shape)
        fx = LowLinkExtractor(codec, deg, batch_size=4, wire="host")
        assert fx._fn is None  # never built a jit function
        for p in fx.extract(exact):
            np.testing.assert_array_equal(p, PAYLOAD)

    def test_host_wire_multi_variant(self, rng):
        """Host wire through the V>=3 (two-plane-eligible) path: each
        variant's frames decode to that variant's payload."""
        codec = DwtDctSvd()
        frames = natural_frames(rng, 4, 64, 96)
        cap = codec.wm_capacity(frames.shape[1:])
        wms = [Shuffler(key=0).generate_wm(payload_for_segment(1, c), cap)
               for c in range(3)]
        mm = LowLinkMarker(codec, wms, batch_size=4, wire="host")
        got = mm.mark_all(frames)
        deg = DeShuffler(key=0, threshold="fixed").set_shape((8,))
        fx = LowLinkExtractor(codec, deg, batch_size=4, wire="host")
        for v in range(3):
            recovered = list(fx.extract(got[v]))
            vote = (np.mean(recovered, 0) >= 0.5).astype(np.uint8)
            np.testing.assert_array_equal(vote, payload_for_segment(1, v))

    def test_lowlink_off_by_default_without_probe(self, monkeypatch):
        """With neither VFP_LOWLINK nor VFP_LL_WIRE set the transport is off
        and the wire defaults to 'u8': no backend probe decides it."""
        from vfp_tpu.pipeline import lowlink
        from vfp_tpu.pipeline.embedder import use_lowlink

        monkeypatch.delenv("VFP_LL_WIRE", raising=False)
        monkeypatch.delenv("VFP_LOWLINK", raising=False)
        assert not hasattr(lowlink, "backend_reachable")
        assert lowlink.default_wire() == "u8"
        assert use_lowlink(DwtDctSvd()) is False

    def test_lowlink_on_only_when_asked(self, monkeypatch):
        """VFP_LOWLINK=1 or an explicit wire turns it on for the flagship;
        VFP_LOWLINK=0 wins over a wire; other codecs never use it."""
        from vfp_tpu.pipeline.embedder import use_lowlink
        from vfp_tpu.wm import DctQim

        monkeypatch.delenv("VFP_LL_WIRE", raising=False)
        monkeypatch.setenv("VFP_LOWLINK", "1")
        assert use_lowlink(DwtDctSvd()) is True
        assert use_lowlink(DctQim()) is False
        monkeypatch.delenv("VFP_LOWLINK")
        monkeypatch.setenv("VFP_LL_WIRE", "host")
        assert use_lowlink(DwtDctSvd()) is True
        monkeypatch.setenv("VFP_LOWLINK", "0")
        assert use_lowlink(DwtDctSvd()) is False

    def test_two_plane_packed_u8(self, rng):
        """The packed two-plane dispatcher under the u8 wire: variants
        recover their payloads (the packer encodes at flush time)."""
        from vfp_tpu.pipeline.lowlink import PackedTwoPlane

        codec = DwtDctSvd()
        frames = natural_frames(rng, 6, 64, 96)
        cap = codec.wm_capacity(frames.shape[1:])
        wms = [Shuffler(key=0).generate_wm(payload_for_segment(1, c), cap)
               for c in range(3)]
        packer = PackedTwoPlane(codec, pack=4, wire="u8")
        mm = LowLinkMarker(codec, wms, batch_size=4, packer=packer, wire="u8")
        h1 = mm.submit(frames[:4])
        h2 = mm.submit(frames[4:])
        packer.flush()
        got = np.concatenate([mm.collect(h1), mm.collect(h2)], axis=1)
        deg = DeShuffler(key=0, threshold="fixed").set_shape((8,))
        for v in range(3):
            bits = np.asarray(codec.extract_frames(jnp.asarray(got[v])))
            for b in bits:
                np.testing.assert_array_equal(
                    deg.degenerate(b), payload_for_segment(1, v))


class TestFlatAdapt:
    """u8-wire flat-content hysteresis (lowlink._FlatAdapt): when collects
    keep repairing ~every block, the device call adds no information — the
    marker must route later batches through the host twin and periodically
    re-probe the device."""

    def test_flat_video_switches_to_host_and_probes(self, rng):
        from vfp_tpu.pipeline.lowlink import _FlatAdapt

        codec = DwtDctSvd()
        g = (rng.rand(2, 64, 96, 1) * 30 + 100).astype(np.uint8)
        frames = np.repeat(g, 3, axis=3)  # grayscale: flat U LL everywhere
        cap = codec.wm_capacity(frames.shape[1:])
        wms = [jnp.asarray(rng.randint(0, 2, cap), jnp.float32)
               for _ in range(3)]
        m = LowLinkMarker(codec, wms, batch_size=2, wire="u8")
        want = LowLinkMarker(codec, wms, batch_size=2,
                             wire="host").mark_all(frames)
        tags, outs = [], []
        for _ in range(_FlatAdapt.ON_AFTER + _FlatAdapt.PROBE_EVERY + 1):
            h = m.submit(frames)
            tags.append(h[3])
            outs.append(m.collect(h))
        on = _FlatAdapt.ON_AFTER
        # warmup batches hit the device (corr tuple carries the wire pair)
        assert all(isinstance(t, tuple) for t in tags[:on]), tags[:on]
        # then the host twin takes over ...
        assert all(t == "host" for t in tags[on:on + _FlatAdapt.PROBE_EVERY - 1])
        # ... with a device re-probe every PROBE_EVERY host batches
        assert isinstance(tags[on + _FlatAdapt.PROBE_EVERY - 1], tuple)
        assert tags[on + _FlatAdapt.PROBE_EVERY] == "host"
        # every batch - device, host, probe - is decision-identical
        for o in outs:
            np.testing.assert_array_equal(o, want)

    def test_natural_video_stays_on_device(self, rng):
        codec = DwtDctSvd()
        frames = natural_frames(rng, 2, 64, 96)
        cap = codec.wm_capacity(frames.shape[1:])
        wms = [jnp.asarray(rng.randint(0, 2, cap), jnp.float32)
               for _ in range(3)]
        m = LowLinkMarker(codec, wms, batch_size=2, wire="u8")
        for _ in range(6):
            h = m.submit(frames)
            assert isinstance(h[3], tuple)  # never leaves the wire
            m.collect(h)
        assert m._adapt.streak == 0

    def test_packer_shares_adapt_across_markers(self, rng):
        from vfp_tpu.pipeline.lowlink import PackedTwoPlane

        codec = DwtDctSvd()
        packer = PackedTwoPlane(codec, pack=4, wire="u8")
        cap = codec.wm_capacity((64, 96, 3))
        wms = [jnp.asarray(rng.randint(0, 2, cap), jnp.float32)
               for _ in range(3)]
        m1 = LowLinkMarker(codec, wms, batch_size=2, packer=packer, wire="u8")
        m2 = LowLinkMarker(codec, wms, batch_size=2, packer=packer, wire="u8")
        assert m1._adapt is packer.adapt and m2._adapt is packer.adapt


class TestWireAwareCaches:
    def test_cached_bit_extractor_keyed_by_wire(self, monkeypatch):
        """A wire change mid-process (bench _host entries, outage recovery)
        must not reuse an extractor bound to the previous wire."""
        from vfp_tpu.pipeline.extractor import cached_bit_extractor

        codec = DwtDctSvd()
        monkeypatch.setenv("VFP_LOWLINK", "1")
        monkeypatch.setenv("VFP_LL_WIRE", "u8")
        a = cached_bit_extractor(codec, 0, 8)
        assert a._ll is not None and a._ll.wire == "u8"
        monkeypatch.setenv("VFP_LL_WIRE", "host")
        b = cached_bit_extractor(codec, 0, 8)
        assert b is not a and b._ll.wire == "host"
        monkeypatch.setenv("VFP_LL_WIRE", "u8")
        assert cached_bit_extractor(codec, 0, 8) is a

    def test_default_wire_rejects_typo(self, monkeypatch):
        from vfp_tpu.pipeline.lowlink import default_wire

        monkeypatch.setenv("VFP_LL_WIRE", "hostonly")
        with pytest.raises(ValueError, match="VFP_LL_WIRE"):
            default_wire()


class TestU8WireContentSweep:
    """Property sweep for the WIRE_DIR_GAMMA2 flat-block repair gate
    (VERDICT r4 item 7): the gate was discovered via one grayscale fixture;
    this pins DECISION identity to the exact path across synthetic content
    classes spanning the AC(X)/AC(E) ratio the gate thresholds on — flat,
    near-flat noise at several amplitudes (gate boundary both sides),
    gradients, checkerboards, and natural-ish texture, in gray (U LL
    constant — the degenerate direction case) and color."""

    def _content(self, rng, kind, amp, h=64, w=96):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        if kind == "flat":
            base = np.full((4, h, w), 128.0, np.float32)
        elif kind == "gradient":
            base = 60.0 + amp * (xx + yy)[None] / (h + w) * np.ones((4, 1, 1))
        elif kind == "checker":
            base = 128.0 + amp * (((yy // 8 + xx // 8) % 2) * 2 - 1)[None] \
                * np.ones((4, 1, 1), np.float32)
        elif kind == "noise":
            base = 128.0 + amp * rng.randn(4, h, w).astype(np.float32)
        else:
            raise ValueError(kind)
        return base

    @pytest.mark.parametrize("color", ["gray", "color"])
    def test_decision_identity_across_classes(self, rng, color):
        import jax

        codec = DwtDctSvd()
        h, w = 64, 96
        nb = (h // 8) * (w // 8)
        cap = codec.wm_capacity((h, w, 3))
        wm = Shuffler(key=0).generate_wm(PAYLOAD, cap)
        wmf = np.asarray(wm).reshape(-1)
        cases = ([("flat", 0.0)]
                 + [("noise", a) for a in (0.25, 1.0, 4.0, 16.0, 48.0)]
                 + [("gradient", 64.0), ("gradient", 8.0)]
                 + [("checker", 2.0), ("checker", 24.0)])
        failures = []
        for kind, amp in cases:
            base = self._content(rng, kind, amp)
            if color == "gray":
                frames = np.clip(base, 0, 255).astype(np.uint8)[..., None]
                frames = np.repeat(frames, 3, axis=3)
            else:
                chroma = rng.randn(4, 1, 1, 3).astype(np.float32) * 12
                frames = np.clip(base[..., None] + chroma, 0, 255).astype(np.uint8)
            got = LowLinkMarker(codec, [wm], batch_size=4,
                                wire="u8").mark_all(frames)[0]
            exact = np.asarray(codec.mark_frames(
                jnp.asarray(frames), jnp.asarray(wmf, jnp.float32)))
            bits = np.asarray(codec.extract_frames(jnp.asarray(got)))
            bits_exact = np.asarray(codec.extract_frames(jnp.asarray(exact)))
            mism = int((bits[:, :nb] != bits_exact[:, :nb]).sum())
            if mism:
                failures.append((kind, amp, mism))
        assert not failures, failures
