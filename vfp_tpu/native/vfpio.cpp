// vfpio: native frame I/O engine for the vfp_tpu pipeline.
//
// The reference's I/O is a Python loop over ffmpeg pipes, one frame per
// read() (reference: src/offmark/video/frame_reader.py:53-64).  This engine
// moves streaming off the GIL: a producer thread reads frames (from a raw
// frame file or any command producing rawvideo on stdout, e.g. ffmpeg) into
// a ring of preallocated buffers while Python and the device consume previous batches.
// The writer mirrors it with a consumer thread draining a ring into a file
// or a command's stdin.
//
// C ABI (ctypes-friendly):
//   void* vfpio_reader_open_file(const char* path, long frame_bytes, int ring, long skip)
//   void* vfpio_reader_open_cmd (const char* cmd,  long frame_bytes, int ring)
//   long  vfpio_read_batch(void* h, unsigned char* out, long max_frames)
//   void  vfpio_reader_close(void* h)
//   void* vfpio_writer_open_file(const char* path, long frame_bytes, int ring)
//   void* vfpio_writer_open_cmd (const char* cmd,  long frame_bytes, int ring)
//   long  vfpio_write_batch(void* h, const unsigned char* data, long frames)
//   int   vfpio_writer_close(void* h)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Ring {
    std::vector<std::vector<unsigned char>> slots;
    std::vector<long> fill;  // bytes valid in slot
    size_t head = 0, tail = 0, count = 0;
    std::mutex mu;
    std::condition_variable cv_put, cv_get;
    bool done = false;

    explicit Ring(int n, long cap) : slots(n), fill(n, 0) {
        for (auto& s : slots) s.resize(cap);
    }
};

struct Reader {
    FILE* f = nullptr;
    bool is_pipe = false;
    long frame_bytes = 0;
    long batch_frames = 0;
    Ring* ring = nullptr;
    std::thread th;

    void produce() {
        const long cap = frame_bytes * batch_frames;
        for (;;) {
            std::unique_lock<std::mutex> lk(ring->mu);
            ring->cv_put.wait(lk, [&] { return ring->count < ring->slots.size() || ring->done; });
            if (ring->done) break;
            size_t slot = ring->head;
            lk.unlock();

            long got = (long)fread(ring->slots[slot].data(), 1, cap, f);
            // only whole frames
            got -= got % frame_bytes;

            lk.lock();
            ring->fill[slot] = got;
            ring->head = (ring->head + 1) % ring->slots.size();
            ring->count++;
            bool eof = got < cap;
            if (eof) ring->done = true;
            lk.unlock();
            ring->cv_get.notify_one();
            if (eof) break;
        }
        ring->cv_get.notify_all();
    }
};

struct Writer {
    FILE* f = nullptr;
    bool is_pipe = false;
    long frame_bytes = 0;
    long batch_frames = 0;
    Ring* ring = nullptr;
    std::thread th;
    std::atomic<bool> error{false};

    void consume() {
        for (;;) {
            std::unique_lock<std::mutex> lk(ring->mu);
            ring->cv_get.wait(lk, [&] { return ring->count > 0 || ring->done; });
            if (ring->count == 0 && ring->done) break;
            size_t slot = ring->tail;
            long n = ring->fill[slot];
            lk.unlock();

            if ((long)fwrite(ring->slots[slot].data(), 1, n, f) != n) error = true;

            lk.lock();
            ring->tail = (ring->tail + 1) % ring->slots.size();
            ring->count--;
            lk.unlock();
            ring->cv_put.notify_one();
        }
    }
};

constexpr long kBatchFrames = 16;

Reader* open_reader(FILE* f, bool pipe, long frame_bytes, int ring_slots) {
    if (!f) return nullptr;
    auto* r = new Reader();
    r->f = f;
    r->is_pipe = pipe;
    r->frame_bytes = frame_bytes;
    r->batch_frames = kBatchFrames;
    r->ring = new Ring(ring_slots > 0 ? ring_slots : 4, frame_bytes * kBatchFrames);
    r->th = std::thread([r] { r->produce(); });
    return r;
}

Writer* open_writer(FILE* f, bool pipe, long frame_bytes, int ring_slots) {
    if (!f) return nullptr;
    auto* w = new Writer();
    w->f = f;
    w->is_pipe = pipe;
    w->frame_bytes = frame_bytes;
    w->batch_frames = kBatchFrames;
    w->ring = new Ring(ring_slots > 0 ? ring_slots : 4, frame_bytes * kBatchFrames);
    w->th = std::thread([w] { w->consume(); });
    return w;
}

}  // namespace

extern "C" {

void* vfpio_reader_open_file(const char* path, long frame_bytes, int ring, long skip) {
    FILE* f = fopen(path, "rb");
    if (f && skip > 0) fseek(f, skip, SEEK_SET);
    return open_reader(f, false, frame_bytes, ring);
}

void* vfpio_reader_open_cmd(const char* cmd, long frame_bytes, int ring) {
    return open_reader(popen(cmd, "r"), true, frame_bytes, ring);
}

long vfpio_read_batch(void* h, unsigned char* out, long max_frames) {
    auto* r = static_cast<Reader*>(h);
    long want = max_frames * r->frame_bytes;
    long copied = 0;
    while (copied < want) {
        std::unique_lock<std::mutex> lk(r->ring->mu);
        r->ring->cv_get.wait(lk, [&] { return r->ring->count > 0 || r->ring->done; });
        if (r->ring->count == 0) break;  // done and drained
        size_t slot = r->ring->tail;
        long avail = r->ring->fill[slot];
        long take = std::min(avail, want - copied);
        lk.unlock();

        memcpy(out + copied, r->ring->slots[slot].data(), take);
        copied += take;

        lk.lock();
        if (take == avail) {
            r->ring->tail = (r->ring->tail + 1) % r->ring->slots.size();
            r->ring->count--;
            lk.unlock();
            r->ring->cv_put.notify_one();
        } else {
            // partial consume: shift remainder to front
            auto& s = r->ring->slots[slot];
            memmove(s.data(), s.data() + take, avail - take);
            r->ring->fill[slot] = avail - take;
            lk.unlock();
        }
    }
    return copied / r->frame_bytes;
}

void vfpio_reader_close(void* h) {
    auto* r = static_cast<Reader*>(h);
    {
        std::lock_guard<std::mutex> lk(r->ring->mu);
        r->ring->done = true;
    }
    r->ring->cv_put.notify_all();
    r->ring->cv_get.notify_all();
    if (r->th.joinable()) r->th.join();
    if (r->is_pipe) pclose(r->f); else fclose(r->f);
    delete r->ring;
    delete r;
}

void* vfpio_writer_open_file(const char* path, long frame_bytes, int ring) {
    return open_writer(fopen(path, "ab"), false, frame_bytes, ring);
}

void* vfpio_writer_open_cmd(const char* cmd, long frame_bytes, int ring) {
    return open_writer(popen(cmd, "w"), true, frame_bytes, ring);
}

long vfpio_write_batch(void* h, const unsigned char* data, long frames) {
    auto* w = static_cast<Writer*>(h);
    long total = frames * w->frame_bytes;
    long pushed = 0;
    const long cap = w->frame_bytes * w->batch_frames;
    while (pushed < total) {
        std::unique_lock<std::mutex> lk(w->ring->mu);
        w->ring->cv_put.wait(lk, [&] { return w->ring->count < w->ring->slots.size(); });
        size_t slot = w->ring->head;
        lk.unlock();

        long take = std::min(cap, total - pushed);
        memcpy(w->ring->slots[slot].data(), data + pushed, take);
        pushed += take;

        lk.lock();
        w->ring->fill[slot] = take;
        w->ring->head = (w->ring->head + 1) % w->ring->slots.size();
        w->ring->count++;
        lk.unlock();
        w->ring->cv_get.notify_one();
    }
    return w->error ? -1 : frames;
}

// Fused LL-delta frame reconstruct for the low-link transport
// (pipeline/lowlink.py): out = clip(src + lut_c[dll_quad + 128]) over the
// [2*hc, 2*wc] region, channels with a null LUT (and pixels outside the
// region) copied through.  Bit-exact with the NumPy path (same int16 LUT
// add + clamp); one pass per row with the per-channel delta row built once
// per 2x2 row pair, so the hot loop is a contiguous saturating add the
// compiler vectorizes.  Runs without the GIL via ctypes.
void vfpio_reconstruct(const unsigned char* src, const signed char* dll,
                       const short* lut_b, const short* lut_g,
                       const short* lut_r, unsigned char* out,
                       long k, long h, long w, long hc, long wc) {
    const long w2 = 2 * wc, h2 = 2 * hc;
    const long row_bytes = w * 3;
    const long n = w2 * 3;
    std::vector<short> drow(n, 0);  // null-LUT channels stay 0
    const short* luts[3] = {lut_b, lut_g, lut_r};
    for (long f = 0; f < k; ++f) {
        const unsigned char* s = src + f * h * row_bytes;
        unsigned char* o = out + f * h * row_bytes;
        const signed char* d = dll + f * hc * wc;
        for (long y = 0; y < h; ++y) {
            const unsigned char* sr = s + y * row_bytes;
            unsigned char* orow = o + y * row_bytes;
            if (y >= h2) {
                std::memcpy(orow, sr, row_bytes);
                continue;
            }
            if ((y & 1) == 0) {
                const signed char* dr = d + (y >> 1) * wc;
                for (int c = 0; c < 3; ++c) {
                    const short* lut = luts[c];
                    if (!lut) continue;
                    for (long x = 0; x < wc; ++x) {
                        short v = lut[(int)dr[x] + 128];
                        drow[(2 * x) * 3 + c] = v;
                        drow[(2 * x + 1) * 3 + c] = v;
                    }
                }
            }
            for (long i = 0; i < n; ++i) {
                int v = (int)sr[i] + (int)drow[i];
                orow[i] = (unsigned char)(v < 0 ? 0 : (v > 255 ? 255 : v));
            }
            if (w2 < w) std::memcpy(orow + n, sr + n, (w - w2) * 3);
        }
    }
}

// Fused host-LL for the low-link transport (pipeline/lowlink.py host_ll):
// u8 BGR frames -> f16 LL band of one YUV channel in ONE pass.
//   c(x, y) = m0*B + m1*G + m2*R + off       (per pixel, f32)
//   ll      = (c00 + c01 + c10 + c11) * 0.5  (2x2 quad, same add order as
//                                             the NumPy path)
// The NumPy/cv2 composition walks the frame ~5 times through freshly
// allocated f32 intermediates (~13 ms/frame at 480p, allocator-bound); this
// reads the u8 row pair once and writes only the f16 LL row (GIL released
// via ctypes).  f32->f16 uses _Float16 (F16C), round-to-nearest-even like
// numpy's astype.  Outputs may differ from the cv2 path by 1 f16 ulp on
// values that land exactly on an f16 rounding boundary (different but valid
// f32 association) — inside the transport's documented f16-quantization
// tolerance.  Parity pinned in tests/test_native.py.
void vfpio_host_ll(const unsigned char* src, _Float16* out,
                   long k, long h, long w, long h4, long w4,
                   float m0, float m1, float m2, float off) {
    const long hc = h4 / 2, wc = w4 / 2;
    const long row_bytes = w * 3;
    std::vector<float> c0(w4), c1(w4);
    for (long f = 0; f < k; ++f) {
        const unsigned char* base = src + f * h * row_bytes;
        _Float16* ofr = out + f * hc * wc;
        for (long y = 0; y < hc; ++y) {
            const unsigned char* r0 = base + (2 * y) * row_bytes;
            const unsigned char* r1 = r0 + row_bytes;
            for (long x = 0; x < w4; ++x) {
                c0[x] = m0 * r0[3 * x] + m1 * r0[3 * x + 1] + m2 * r0[3 * x + 2] + off;
                c1[x] = m0 * r1[3 * x] + m1 * r1[3 * x + 1] + m2 * r1[3 * x + 2] + off;
            }
            _Float16* orow = ofr + y * wc;
            for (long x = 0; x < wc; ++x) {
                float s = ((c0[2 * x] + c0[2 * x + 1]) + c1[2 * x]) + c1[2 * x + 1];
                orow[x] = (_Float16)(s * 0.5f);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Host-only QIM transport kernels (pipeline/lowlink.py wire='host').
//
// Per 4x4 LL block: Gram matrix, 5 Frobenius-normalized squarings (the same
// power-by-squaring count as ops/soa.top_triplet_soa and lowlink._host_triplet
// — error decays like (l2/l1)^32), dominant right/left vectors, s0, QIM
// target, and the rank-1 int8 delta — one pass per block, no intermediate
// arrays.  The NumPy twin walks ~20 full-size temporaries per squaring; this
// runs ~10x faster on the one host core and is the hot stage of the
// zero-link workflow path.  s0 agrees with the NumPy twin to float noise,
// which can only move a QIM target to a neighbouring *valid* centre for the
// same bit (tests/test_native.py pins decision parity).

namespace {

// ops/soa._V0 ([1, 0.93, 1.08, 1.02] normalized), same f32 values
const float kV0[4] = {0.4955781102180481f, 0.4608876407146454f,
                      0.5352243781089783f, 0.5054896473884583f};

// Dominant triplet of one 4x4 block: returns s0, fills u[4], v[4].
inline float triplet4(const float x[16], float* u, float* v) {
    const float eps = 1e-20f;
    float g[16], h[16];
    for (int a = 0; a < 4; ++a)
        for (int b = a; b < 4; ++b) {
            float s = x[0 * 4 + a] * x[0 * 4 + b];
            for (int r = 1; r < 4; ++r) s += x[r * 4 + a] * x[r * 4 + b];
            g[a * 4 + b] = s;
            g[b * 4 + a] = s;
        }
    for (int it = 0; it < 5; ++it) {
        float n2 = 0.f;
        for (int i = 0; i < 16; ++i) n2 += g[i] * g[i];
        float inv = 1.0f / std::max(std::sqrt(n2), eps);
        for (int i = 0; i < 16; ++i) g[i] *= inv;
        for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 4; ++j) {
                float s = g[i * 4 + 0] * g[0 * 4 + j];
                for (int k2 = 1; k2 < 4; ++k2) s += g[i * 4 + k2] * g[k2 * 4 + j];
                h[i * 4 + j] = s;
            }
        std::memcpy(g, h, sizeof(g));
    }
    float vn2 = 0.f;
    for (int i = 0; i < 4; ++i) {
        float s = 0.f;
        for (int j = 0; j < 4; ++j) s += g[i * 4 + j] * kV0[j];
        v[i] = s;
        vn2 += s * s;
    }
    float vn = std::sqrt(vn2);
    if (vn > eps) {
        for (int i = 0; i < 4; ++i) v[i] /= vn;
    } else {
        for (int i = 0; i < 4; ++i) v[i] = kV0[i];
    }
    float s0sq = 0.f;
    for (int r = 0; r < 4; ++r) {
        float s = 0.f;
        for (int c = 0; c < 4; ++c) s += x[r * 4 + c] * v[c];
        u[r] = s;
        s0sq += s * s;
    }
    float s0 = std::sqrt(s0sq);
    if (s0 > eps) {
        for (int r = 0; r < 4; ++r) u[r] /= s0;
    } else {
        u[0] = 1.f;
        u[1] = u[2] = u[3] = 0.f;
    }
    return s0;
}

}  // namespace

// f16 LL [k, hc, wc] + per-plane block bits [P, nbh*nbw] (u8 0/1, blocks
// row-major) -> int8 QIM LL delta [P, k, hc, wc] (fixed-point /8), matching
// lowlink.host_dll.  blk is fixed at 4 (the flagship's only block size).
void vfpio_qim_dll(const _Float16* ll, const unsigned char* bits,
                   signed char* out, long P, long k, long hc, long wc,
                   float scale) {
    const long nbh = hc / 4, nbw = wc / 4, nb = nbh * nbw;
    std::memset(out, 0, (size_t)(P * k * hc * wc));
    for (long f = 0; f < k; ++f) {
        const _Float16* lf = ll + f * hc * wc;
        for (long bi = 0; bi < nbh; ++bi)
            for (long bj = 0; bj < nbw; ++bj) {
                float x[16], u[4], v[4];
                for (int r = 0; r < 4; ++r)
                    for (int c = 0; c < 4; ++c)
                        x[r * 4 + c] = (float)lf[(bi * 4 + r) * wc + bj * 4 + c];
                float s0 = triplet4(x, u, v);
                float cell = std::floor(s0 / scale);
                for (long p = 0; p < P; ++p) {
                    float bit = (float)bits[p * nb + bi * nbw + bj];
                    float ds = (cell + 0.25f + 0.5f * bit) * scale - s0;
                    signed char* o =
                        out + ((p * k + f) * hc + bi * 4) * wc + bj * 4;
                    for (int r = 0; r < 4; ++r)
                        for (int c = 0; c < 4; ++c) {
                            float q = std::nearbyint(ds * u[r] * v[c] * 8.0f);
                            q = q < -127.f ? -127.f : (q > 127.f ? 127.f : q);
                            o[r * wc + c] = (signed char)q;
                        }
                }
            }
    }
}

// f16 LL [k, hc, wc] -> decoded bits u8 [k, nbh*nbw] (blocks row-major):
// bit = (s0 mod scale) > scale/2, matching lowlink.host_extract_bits.
// Masked exact-triplet repair for the u8-wire recentre
// (lowlink._repair_small_blocks hot path): for each block flagged in mask
// [P, k, nbh, nbw], recompute the QIM delta from the TRUE f16 LL with the
// same triplet4 power iteration as vfpio_qim_dll and overwrite that block
// of out [P, k, hc, wc] (int8 fixed-point x8, DLL_Q).  The triplet is
// solved once per frame-block and shared across flagged planes (s0/u/v are
// bit-independent).  blk is fixed at 4 (triplet4); other blocks untouched.
void vfpio_qim_repair(const _Float16* ll, const unsigned char* mask,
                      const unsigned char* bits, signed char* out,
                      long P, long k, long hc, long wc, float scale) {
    const long nbh = hc / 4, nbw = wc / 4, nb = nbh * nbw;
    for (long f = 0; f < k; ++f) {
        const _Float16* lf = ll + f * hc * wc;
        for (long bi = 0; bi < nbh; ++bi)
            for (long bj = 0; bj < nbw; ++bj) {
                bool any = false;
                for (long p = 0; p < P && !any; ++p)
                    any = mask[((p * k + f) * nbh + bi) * nbw + bj] != 0;
                if (!any) continue;
                float x[16], u[4], v[4];
                for (int r = 0; r < 4; ++r)
                    for (int c = 0; c < 4; ++c)
                        x[r * 4 + c] = (float)lf[(bi * 4 + r) * wc + bj * 4 + c];
                const float s0 = triplet4(x, u, v);
                const float base = std::floor(s0 / scale) + 0.25f;
                for (long p = 0; p < P; ++p) {
                    if (!mask[((p * k + f) * nbh + bi) * nbw + bj]) continue;
                    const float bit = (float)bits[p * nb + bi * nbw + bj];
                    const float ds = (base + 0.5f * bit) * scale - s0;
                    signed char* o =
                        out + ((p * k + f) * hc + bi * 4) * wc + bj * 4;
                    for (int r = 0; r < 4; ++r)
                        for (int c = 0; c < 4; ++c) {
                            float q = std::nearbyint(ds * u[r] * v[c] * 8.0f);
                            q = q < -127.f ? -127.f : (q > 127.f ? 127.f : q);
                            o[r * wc + c] = (signed char)q;
                        }
                }
            }
    }
}

void vfpio_qim_bits(const _Float16* ll, unsigned char* out,
                    long k, long hc, long wc, float scale) {
    const long nbh = hc / 4, nbw = wc / 4;
    for (long f = 0; f < k; ++f) {
        const _Float16* lf = ll + f * hc * wc;
        unsigned char* of = out + f * nbh * nbw;
        for (long bi = 0; bi < nbh; ++bi)
            for (long bj = 0; bj < nbw; ++bj) {
                float x[16], u[4], v[4];
                for (int r = 0; r < 4; ++r)
                    for (int c = 0; c < 4; ++c)
                        x[r * 4 + c] = (float)lf[(bi * 4 + r) * wc + bj * 4 + c];
                float s0 = triplet4(x, u, v);
                float m = std::fmod(s0, scale);
                of[bi * nbw + bj] = (unsigned char)(m > scale * 0.5f);
            }
    }
}

// u8-wire recentring, big-block fast path (lowlink.recentre_dll): for each
// blk x blk block of the int8 wire delta q (fixed-point x qscale), compute
// num = <q, E>, den = ||q||^2 and rescale the block by
// alpha = 1 - qscale*num/den (first-order recentring of the marked s0 onto
// its QIM cell centre; derivation in lowlink.py's recentre block comment).
// Blocks whose delta is below the direction-recovery floor
// (den/qscale^2 < du_min^2), or whose TRUE-LL content X fails the
// direction-reliability gate AC(X) < gamma2 * AC(E) (device direction =
// dither pattern; its delta would die in lossy chroma coding), are left at
// their input values and flagged in small_mask [P, k, nbh, nbw] for the
// caller's exact-triplet repair path.  out must enter as a copy of q
// (rows/cols beyond nbh*blk/nbw*blk pass through untouched).  nearbyint
// under the default FP environment matches np.rint (round-half-even).
// ("2" suffix: the gate added an ABI-incompatible X/gamma2 — callers
// hasattr-gate, so a stale prebuilt .so falls back to the gated NumPy path
// instead of silently running ungated.)
void vfpio_recentre2(const signed char* q, const float* E, const float* X,
                     signed char* out, unsigned char* small_mask, long P,
                     long k, long hc, long wc, long blk, float qscale,
                     float du_min, float gamma2) {
    const long nbh = hc / blk, nbw = wc / blk;
    const float den_floor = du_min * du_min * qscale * qscale;
    const float inv_n = 1.0f / (float)(blk * blk);
    for (long f = 0; f < k; ++f) {
        const float* Ef = E + f * hc * wc;
        const float* Xf = X ? X + f * hc * wc : nullptr;
        for (long bi = 0; bi < nbh; ++bi)
            for (long bj = 0; bj < nbw; ++bj) {
                const long r0 = bi * blk, c0 = bj * blk;
                // direction-reliability gate (lowlink.WIRE_DIR_GAMMA2):
                // when the content's AC energy is dominated by the wire
                // error's, the device direction is the dither pattern's —
                // flag for the caller's exact-triplet repair (p-independent)
                bool flat = false;
                if (Xf) {
                    float sx = 0.f, sx2 = 0.f, se = 0.f, se2 = 0.f;
                    for (long r = 0; r < blk; ++r) {
                        const float* xr = Xf + (r0 + r) * wc + c0;
                        const float* er = Ef + (r0 + r) * wc + c0;
                        for (long c = 0; c < blk; ++c) {
                            sx += xr[c];
                            sx2 += xr[c] * xr[c];
                            se += er[c];
                            se2 += er[c] * er[c];
                        }
                    }
                    flat = (sx2 - sx * sx * inv_n)
                           < gamma2 * (se2 - se * se * inv_n);
                }
                for (long p = 0; p < P; ++p) {
                    const signed char* qf = q + (p * k + f) * hc * wc;
                    signed char* of = out + (p * k + f) * hc * wc;
                    unsigned char* sm = small_mask + (p * k + f) * nbh * nbw;
                    if (flat) {
                        sm[bi * nbw + bj] = 1;
                        continue;
                    }
                    float num = 0.f, den = 0.f;
                    for (long r = 0; r < blk; ++r) {
                        const signed char* qr = qf + (r0 + r) * wc + c0;
                        const float* er = Ef + (r0 + r) * wc + c0;
                        for (long c = 0; c < blk; ++c) {
                            const float v = (float)qr[c];
                            num += v * er[c];
                            den += v * v;
                        }
                    }
                    if (den < den_floor) {
                        sm[bi * nbw + bj] = 1;
                        continue;
                    }
                    const float alpha = 1.0f - qscale * num / den;
                    for (long r = 0; r < blk; ++r) {
                        const signed char* qr = qf + (r0 + r) * wc + c0;
                        signed char* orow = of + (r0 + r) * wc + c0;
                        for (long c = 0; c < blk; ++c) {
                            float w = std::nearbyint((float)qr[c] * alpha);
                            w = w < -127.f ? -127.f : (w > 127.f ? 127.f : w);
                            orow[c] = (signed char)w;
                        }
                    }
                }
            }
    }
}

int vfpio_writer_close(void* h) {
    auto* w = static_cast<Writer*>(h);
    {
        std::lock_guard<std::mutex> lk(w->ring->mu);
        w->ring->done = true;
    }
    w->ring->cv_get.notify_all();
    if (w->th.joinable()) w->th.join();
    int rc = w->error ? -1 : 0;
    if (w->is_pipe) pclose(w->f); else fclose(w->f);
    delete w->ring;
    delete w;
    return rc;
}

}  // extern "C"
