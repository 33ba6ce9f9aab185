// Reed-Solomon RS(255,223) batch codec over GF(2^8), poly 0x11d, fcr=0.
//
// Native backend for ofdm_tpu.fec.reed_solomon (same math as the Python
// implementation; behavior parity with the reference's reed_solomon crate —
// /root/reference/src/utils.rs:97-180).  Exposed via a C ABI for ctypes.
// Batch-oriented: encodes/decodes N blocks per call so the streaming FEC
// path amortizes the FFI boundary.

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__GFNI__) && defined(__AVX512F__) && defined(__AVX512BW__)
#include <immintrin.h>
#define RS_GFNI 1
#endif

namespace {

constexpr int kN = 255;
constexpr int kEcc = 32;
constexpr int kK = kN - kEcc;  // 223
constexpr int kPrim = 0x11d;

struct Tables {
    uint8_t exp[512];
    uint8_t log[256];
    uint8_t gen[kEcc + 1];
    // Scalar fallback tables:
    // encode: row f = f * gen[1..32] — the LFSR inner loop becomes one
    // 32-byte XOR (vectorizes to a single AVX2 op)
    alignas(64) uint8_t enc_row[256][kEcc];
    // syndromes: mulx[i][s] = s * alpha^i — per input byte the 32 syndrome
    // chains update independently (ILP across i), one L1 lookup each
    alignas(64) uint8_t mulx[kEcc][256];
    // GFNI batch path: multiply-by-constant in GF(0x11d) is an F2-linear map,
    // i.e. one VGF2P8AFFINEQB with an 8x8 bit matrix (column k of the matrix
    // is c*2^k; qword byte r holds the row driving output bit 7-r).  The
    // batch kernels run 64 independent blocks SoA in ZMM lanes.
    uint64_t affine_gen[kEcc];      // multiply by gen[j+1] (LFSR feedback)
    uint64_t affine_alpha[kEcc];    // multiply by alpha^i (syndrome Horner)

    // Variable*variable GF multiplies (Berlekamp-Massey / Forney) cannot use
    // affine matrices.  VGF2P8MULB / VGF2P8AFFINEINVQB multiply/invert in
    // GF(2^8) with the AES polynomial 0x11b — the WRONG field for RS 0x11d.
    // The fields are isomorphic: pick beta in GF(0x11b) that is a root of
    // the 0x11d polynomial x^8+x^4+x^3+x^2+1; then phi(alpha^k) = beta^k,
    // phi(0) = 0 is a field isomorphism (and F2-linear, so it is one affine
    // transform).  The whole error-correction pipeline runs in the 0x11b
    // domain: syndromes map in once, error magnitudes map out once, and all
    // intermediate mul/inv are native GFNI instructions.
    uint8_t to11b[256];             // phi
    uint8_t from11b[256];           // phi^-1
    uint64_t phi_m, psi_m, ident_m; // affine matrices for phi / phi^-1 / id
    uint8_t chien_c11b[kEcc + 1];   // phi(alpha^-deg), Chien per-step consts
    uint8_t forney_pow[kN][kEcc];   // phi(alpha^{-j*deg}), on-demand omega

    static uint8_t mul11b(uint8_t a, uint8_t b) {   // GF(0x11b) scalar mul
        uint8_t p = 0;
        while (b) {
            if (b & 1) p ^= a;
            b >>= 1;
            a = static_cast<uint8_t>((a & 0x80) ? ((a << 1) ^ 0x1b) : (a << 1));
        }
        return p;
    }

    template <class F>
    static uint64_t map_matrix(F f) {            // F2-linear map -> qword
        uint64_t m = 0;
        for (int r = 0; r < 8; ++r) {            // row r -> output bit 7-r
            const int outbit = 7 - r;
            uint8_t rowbits = 0;
            for (int k = 0; k < 8; ++k) {
                const uint8_t img = f(static_cast<uint8_t>(1 << k));
                rowbits |= ((img >> outbit) & 1) << k;
            }
            m |= static_cast<uint64_t>(rowbits) << (8 * r);
        }
        return m;
    }

    uint64_t mul_matrix(uint8_t c) const {
        return map_matrix([&](uint8_t x) { return mul_raw(c, x); });
    }

    Tables() {
        int x = 1;
        for (int i = 0; i < 255; ++i) {
            exp[i] = static_cast<uint8_t>(x);
            log[x] = static_cast<uint8_t>(i);
            x <<= 1;
            if (x & 0x100) x ^= kPrim;
        }
        for (int i = 255; i < 512; ++i) exp[i] = exp[i - 255];
        log[0] = 0;

        // generator polynomial prod_{i=0}^{31} (x - alpha^i)
        uint8_t g[kEcc + 1] = {1};
        int deg = 0;
        for (int i = 0; i < kEcc; ++i) {
            uint8_t root = exp[i];
            // multiply g by (x - root), coefficients highest-degree-first:
            // ng[j] += g[j] (times x term keeps position as length grows),
            // ng[j+1] += root * g[j]
            uint8_t ng[kEcc + 1] = {0};
            for (int j = 0; j <= deg; ++j) {
                ng[j] ^= g[j];
                ng[j + 1] ^= mul_raw(g[j], root);
            }
            ++deg;
            std::memcpy(g, ng, sizeof(g));
        }
        std::memcpy(gen, g, sizeof(gen));

        for (int f = 0; f < 256; ++f)
            for (int j = 0; j < kEcc; ++j)
                enc_row[f][j] = mul_raw(static_cast<uint8_t>(f), gen[j + 1]);
        for (int i = 0; i < kEcc; ++i) {
            mulx[i][0] = 0;
            for (int s = 1; s < 256; ++s)
                mulx[i][s] = exp[(log[s] + i) % 255];
        }
        for (int j = 0; j < kEcc; ++j) affine_gen[j] = mul_matrix(gen[j + 1]);
        for (int i = 0; i < kEcc; ++i) affine_alpha[i] = mul_matrix(exp[i]);

        // field isomorphism GF(0x11d) -> GF(0x11b)
        uint8_t beta = 0;
        for (int cand = 1; cand < 256 && !beta; ++cand) {
            const uint8_t v = static_cast<uint8_t>(cand);
            const uint8_t v2 = mul11b(v, v), v3 = mul11b(v2, v),
                          v4 = mul11b(v2, v2), v8 = mul11b(v4, v4);
            if (static_cast<uint8_t>(v8 ^ v4 ^ v3 ^ v2 ^ 1) == 0)
                beta = v;
        }
        to11b[0] = 0;
        uint8_t bp = 1;
        for (int k = 0; k < 255; ++k) {              // phi(alpha^k) = beta^k
            to11b[exp[k]] = bp;
            bp = mul11b(bp, beta);
        }
        for (int v = 0; v < 256; ++v) from11b[to11b[v]] = static_cast<uint8_t>(v);
        phi_m = map_matrix([&](uint8_t x) { return to11b[x]; });
        psi_m = map_matrix([&](uint8_t x) { return from11b[x]; });
        ident_m = map_matrix([](uint8_t x) { return x; });
        for (int deg = 0; deg <= kEcc; ++deg)
            chien_c11b[deg] = to11b[exp[(255 - deg % 255) % 255]];
        for (int j = 0; j < kN; ++j)
            for (int deg = 0; deg < kEcc; ++deg)
                forney_pow[j][deg] =
                    to11b[exp[(255 - (j * deg) % 255) % 255]];
    }

    uint8_t mul_raw(uint8_t a, uint8_t b) const {
        if (!a || !b) return 0;
        return exp[log[a] + log[b]];
    }
};

const Tables T;

inline uint8_t gf_mul(uint8_t a, uint8_t b) {
    if (!a || !b) return 0;
    return T.exp[T.log[a] + T.log[b]];
}

inline uint8_t gf_inv(uint8_t a) { return T.exp[255 - T.log[a]]; }

inline uint8_t gf_pow2(int p) {  // alpha^p, p may exceed 255
    p %= 255;
    if (p < 0) p += 255;
    return T.exp[p];
}

[[maybe_unused]] void encode_one(const uint8_t* data, uint8_t* out) {
    // systematic: out = data || parity (LFSR division by generator).
    // Per input byte: rem = (rem << 1 byte) ^ enc_row[factor] — one 32-byte
    // XOR the compiler vectorizes.  Scalar fallback / remainder path; the
    // batch entry point uses the GFNI SoA kernel.
    std::memcpy(out, data, kK);
    uint8_t rem[kEcc + 1] = {0};
    for (int i = 0; i < kK; ++i) {
        const uint8_t factor = data[i] ^ rem[0];
        const uint8_t* row = T.enc_row[factor];
        for (int j = 0; j < kEcc; ++j)
            rem[j] = rem[j + 1] ^ row[j];
    }
    std::memcpy(out + kK, rem, kEcc);
}

void syndromes_one(const uint8_t* block, uint8_t* synd) {
    // S_i = C(alpha^i), coefficients high-to-low (block[0] = x^254), Horner
    // with the byte loop outer so the 32 chains update independently (ILP)
    std::memset(synd, 0, kEcc);
    for (int j = 0; j < kN; ++j) {
        const uint8_t c = block[j];
        for (int i = 0; i < kEcc; ++i)
            synd[i] = T.mulx[i][synd[i]] ^ c;
    }
}

// returns 1 on success (block corrected in place), 0 on failure
int decode_with_syndromes(uint8_t* block, const uint8_t* synd_in) {
    uint8_t synd[kEcc];
    std::memcpy(synd, synd_in, kEcc);
    bool all_zero = true;
    for (int i = 0; i < kEcc; ++i) all_zero &= (synd[i] == 0);
    if (all_zero) return 1;

    // Berlekamp-Massey
    uint8_t C[kEcc + 1] = {1}, B[kEcc + 1] = {1};
    int L = 0, m = 1;
    uint8_t b = 1;
    for (int n = 0; n < kEcc; ++n) {
        uint8_t d = synd[n];
        for (int i = 1; i <= L; ++i) d ^= gf_mul(C[i], synd[n - i]);
        if (d == 0) {
            ++m;
        } else if (2 * L <= n) {
            uint8_t Tt[kEcc + 1];
            std::memcpy(Tt, C, sizeof(C));
            uint8_t coef = gf_mul(d, gf_inv(b));
            for (int i = 0; i + m <= kEcc; ++i)
                C[i + m] ^= gf_mul(coef, B[i]);
            L = n + 1 - L;
            std::memcpy(B, Tt, sizeof(B));
            b = d;
            m = 1;
        } else {
            uint8_t coef = gf_mul(d, gf_inv(b));
            for (int i = 0; i + m <= kEcc; ++i)
                C[i + m] ^= gf_mul(coef, B[i]);
            ++m;
        }
    }
    if (L > kEcc / 2) return 0;

    // Chien search: error at power j where C(alpha^{-j}) == 0
    int err_pos[kEcc / 2];
    int n_err = 0;
    for (int j = 0; j < kN; ++j) {
        uint8_t xinv = gf_pow2(255 - j);
        uint8_t val = 0, xp = 1;
        for (int deg = 0; deg <= L; ++deg) {
            val ^= gf_mul(C[deg], xp);
            xp = gf_mul(xp, xinv);
        }
        if (val == 0) {
            if (n_err >= kEcc / 2) return 0;
            err_pos[n_err++] = j;
        }
    }
    if (n_err != L) return 0;

    // Forney: omega = (S * C) mod x^ecc ; e = X * omega(X^-1) / C'(X^-1)
    uint8_t omega[kEcc] = {0};
    for (int i = 0; i <= L; ++i) {
        if (!C[i]) continue;
        for (int j = 0; i + j < kEcc; ++j)
            omega[i + j] ^= gf_mul(C[i], synd[j]);
    }
    for (int e = 0; e < n_err; ++e) {
        int j = err_pos[e];
        uint8_t x = gf_pow2(j);
        uint8_t xinv = gf_inv(x);
        uint8_t num = 0, xp = 1;
        for (int deg = 0; deg < kEcc; ++deg) {
            num ^= gf_mul(omega[deg], xp);
            xp = gf_mul(xp, xinv);
        }
        uint8_t den = 0;
        uint8_t xinv2 = gf_mul(xinv, xinv), xq = 1;
        for (int deg = 1; deg <= L; deg += 2) {
            den ^= gf_mul(C[deg], xq);
            xq = gf_mul(xq, xinv2);
        }
        if (!den) return 0;
        uint8_t mag = gf_mul(x, gf_mul(num, gf_inv(den)));
        block[kN - 1 - j] ^= mag;
    }
    return 1;
}

[[maybe_unused]] int decode_one(uint8_t* block) {
    uint8_t synd[kEcc];
    syndromes_one(block, synd);
    return decode_with_syndromes(block, synd);
}

#ifdef RS_GFNI

// 8x8 byte transpose on uint64 rows (recursive block swaps: 4, 2, 1)
inline void transpose8x8(uint64_t x[8]) {
    for (int i = 0; i < 4; ++i) {
        const uint64_t a = x[i], b = x[i + 4];
        x[i] = (a & 0x00000000FFFFFFFFull) | ((b & 0x00000000FFFFFFFFull) << 32);
        x[i + 4] = ((a >> 32) & 0x00000000FFFFFFFFull) | (b & 0xFFFFFFFF00000000ull);
    }
    for (int g = 0; g < 8; g += 4)
        for (int i = g; i < g + 2; ++i) {
            const uint64_t a = x[i], b = x[i + 2];
            x[i] = (a & 0x0000FFFF0000FFFFull) | ((b & 0x0000FFFF0000FFFFull) << 16);
            x[i + 2] = ((a >> 16) & 0x0000FFFF0000FFFFull) | (b & 0xFFFF0000FFFF0000ull);
        }
    for (int i = 0; i < 8; i += 2) {
        const uint64_t a = x[i], b = x[i + 1];
        x[i] = (a & 0x00FF00FF00FF00FFull) | ((b & 0x00FF00FF00FF00FFull) << 8);
        x[i + 1] = ((a >> 8) & 0x00FF00FF00FF00FFull) | (b & 0xFF00FF00FF00FF00ull);
    }
}

// gather up to 64 blocks (row stride `stride`, `cols` bytes each) into a
// column-major tile cols[256][64]: cols[j][b] = blocks[b][j]
struct Tile {
    alignas(64) uint8_t rows[64][256];   // zero-padded staging
    alignas(64) uint8_t cols[256][64];

    void load(const uint8_t* src, int n, int stride, int n_cols) {
        if (n < 64) std::memset(rows, 0, sizeof(rows));
        for (int b = 0; b < n; ++b)
            std::memcpy(rows[b], src + static_cast<size_t>(b) * stride, n_cols);
        for (int g = 0; g * 8 < n_cols; ++g)
            for (int r = 0; r < 64; r += 8) {
                uint64_t x[8];
                for (int i = 0; i < 8; ++i)
                    std::memcpy(&x[i], &rows[r + i][g * 8], 8);
                transpose8x8(x);
                for (int j = 0; j < 8; ++j)
                    std::memcpy(&cols[g * 8 + j][r], &x[j], 8);
            }
    }

    // inverse of load: scatter (possibly corrected) columns back to rows
    void store(uint8_t* dst, int n, int stride, int n_cols) {
        for (int g = 0; g * 8 < n_cols; ++g)
            for (int r = 0; r < 64; r += 8) {
                uint64_t x[8];
                for (int j = 0; j < 8; ++j)
                    std::memcpy(&x[j], &cols[g * 8 + j][r], 8);
                transpose8x8(x);
                for (int i = 0; i < 8; ++i)
                    std::memcpy(&rows[r + i][g * 8], &x[i], 8);
            }
        for (int b = 0; b < n; ++b)
            std::memcpy(dst + static_cast<size_t>(b) * stride, rows[b], n_cols);
    }
};

// scatter a [kEcc][64] SoA result back to rows: dst[b][i] = soa[i][b]
inline void scatter32x64(const uint8_t soa[kEcc][64], uint8_t* dst, int n,
                         int stride) {
    alignas(64) uint8_t rows[64][kEcc];
    for (int g = 0; g < kEcc; g += 8)
        for (int r = 0; r < 64; r += 8) {
            uint64_t x[8];
            for (int i = 0; i < 8; ++i)
                std::memcpy(&x[i], &soa[g + i][r], 8);
            transpose8x8(x);
            for (int j = 0; j < 8; ++j)
                std::memcpy(&rows[r + j][g], &x[j], 8);
        }
    for (int b = 0; b < n; ++b)
        std::memcpy(dst + static_cast<size_t>(b) * stride, rows[b], kEcc);
}

// encode 64 blocks SoA: the LFSR runs in ZMM lanes, the per-step feedback
// multiplies gen[j+1] are VGF2P8AFFINEQB with precomputed bit matrices
void encode_batch64(const uint8_t* in, int n, uint8_t* out) {
    static thread_local Tile tile;
    tile.load(in, n, kK, kK);
    __m512i rem[kEcc];
    for (int j = 0; j < kEcc; ++j) rem[j] = _mm512_setzero_si512();
    for (int i = 0; i < kK; ++i) {
        const __m512i data = _mm512_load_si512(tile.cols[i]);
        const __m512i factor = _mm512_xor_si512(data, rem[0]);
        for (int j = 0; j < kEcc - 1; ++j) {
            const __m512i g = _mm512_set1_epi64(
                static_cast<long long>(T.affine_gen[j]));
            rem[j] = _mm512_xor_si512(
                rem[j + 1], _mm512_gf2p8affine_epi64_epi8(factor, g, 0));
        }
        const __m512i g = _mm512_set1_epi64(
            static_cast<long long>(T.affine_gen[kEcc - 1]));
        rem[kEcc - 1] = _mm512_gf2p8affine_epi64_epi8(factor, g, 0);
    }
    alignas(64) uint8_t soa[kEcc][64];
    for (int j = 0; j < kEcc; ++j) _mm512_store_si512(soa[j], rem[j]);
    for (int b = 0; b < n; ++b)
        std::memcpy(out + static_cast<size_t>(b) * kN,
                    in + static_cast<size_t>(b) * kK, kK);
    scatter32x64(soa, out + kK, n, kN);
}

// syndromes for 64 blocks SoA (Horner: s = s*alpha^i ^ c per byte).
// Processed in two halves of 16 syndromes so the 16 accumulators + 16
// matrices fit the 32-entry ZMM register file (one pass over all 64
// accumulator+matrix registers spills every iteration).
template <int I0>
void syndromes_half(const Tile& tile, uint8_t synd_soa[kEcc][64]) {
    __m512i s[16], a[16];
    for (int i = 0; i < 16; ++i) {
        s[i] = _mm512_setzero_si512();
        a[i] = _mm512_set1_epi64(
            static_cast<long long>(T.affine_alpha[I0 + i]));
    }
    for (int j = 0; j < kN; ++j) {
        const __m512i c = _mm512_load_si512(tile.cols[j]);
        for (int i = 0; i < 16; ++i)
            s[i] = _mm512_xor_si512(
                c, _mm512_gf2p8affine_epi64_epi8(s[i], a[i], 0));
    }
    for (int i = 0; i < 16; ++i) _mm512_store_si512(synd_soa[I0 + i], s[i]);
}

void syndromes_from_tile(const Tile& tile, uint8_t synd_soa[kEcc][64]) {
    syndromes_half<0>(tile, synd_soa);
    syndromes_half<16>(tile, synd_soa);
}

inline __m512i gfmul(__m512i a, __m512i b) {         // GF(0x11b) a*b
    return _mm512_gf2p8mul_epi8(a, b);
}
inline __m512i gfmulc(__m512i a, uint8_t c) {        // GF(0x11b) a*const
    return _mm512_gf2p8mul_epi8(a, _mm512_set1_epi8(static_cast<char>(c)));
}
inline __m512i gfaff(__m512i x, uint64_t m) {        // F2-linear map
    return _mm512_gf2p8affine_epi64_epi8(
        x, _mm512_set1_epi64(static_cast<long long>(m)), 0);
}
inline __m512i gfinv(__m512i x) {                    // GF(0x11b) x^-1, 0->0
    return _mm512_gf2p8affineinv_epi64_epi8(
        x, _mm512_set1_epi64(static_cast<long long>(T.ident_m)), 0);
}

// Error correction for a whole 64-block tile, SoA in ZMM lanes, branchless
// over blocks (clean lanes run through as L=0 no-ops and report ok).  All
// field math happens in the GF(0x11b) domain via the phi isomorphism (see
// Tables): syndromes map in once, magnitudes map out once.  Per errored
// TILE this costs ~40k vector ops — ~25x faster than the scalar
// per-block Berlekamp-Massey path it replaces.
void correct_batch64(Tile& tile, const uint8_t synd_soa[kEcc][64], int n,
                     uint8_t* ok) {
    const __m512i zero = _mm512_setzero_si512();
    const __m512i one = _mm512_set1_epi8(1);
    __m512i S[kEcc];
    for (int i = 0; i < kEcc; ++i)
        S[i] = gfaff(_mm512_load_si512(synd_soa[i]), T.phi_m);

    // Berlekamp-Massey, delay-line form: B absorbs the x^m gap by shifting
    // one degree per iteration, so the polynomial update is uniform across
    // lanes (no per-lane shift).  Branches become byte-mask blends.
    // B starts at x (not 1): the end-of-iteration shift supplies one x per
    // no-reset step, so B here is always x^m * B_classic at use time.
    __m512i C[kEcc + 1], B[kEcc + 1];
    C[0] = one;
    B[0] = zero;
    B[1] = one;
    for (int i = 1; i <= kEcc; ++i) C[i] = zero;
    for (int i = 2; i <= kEcc; ++i) B[i] = zero;
    __m512i L = zero, binv = one;
    for (int nn = 0; nn < kEcc; ++nn) {
        __m512i d = S[nn];                           // discrepancy (C[0]=1)
        for (int i = 1; i <= nn; ++i)
            d = _mm512_xor_si512(d, gfmul(C[i], S[nn - i]));
        const __mmask64 dnz = _mm512_test_epi8_mask(
            d, _mm512_set1_epi8(static_cast<char>(0xFF)));
        const __m512i dinv = gfinv(d);
        const __m512i coef = _mm512_maskz_mov_epi8(dnz, gfmul(d, binv));
        const __mmask64 swap = dnz & _mm512_cmple_epu8_mask(
            _mm512_add_epi8(L, L), _mm512_set1_epi8(static_cast<char>(nn)));
        // degree bound: after iteration nn, deg C <= ceil((nn+1)/2) + 1 and
        // deg B (delay-line form, one x per step) <= nn + 1 — terms above
        // that are structurally zero, so the polynomial update and the
        // B shift need not touch them (halves the BM work on average)
        const int dmax = nn + 1 < kEcc ? nn + 1 : kEcc;
        for (int i = 0; i <= dmax; ++i) {
            const __m512i ci = C[i];
            C[i] = _mm512_xor_si512(ci, gfmul(coef, B[i]));
            B[i] = _mm512_mask_mov_epi8(B[i], swap, ci);
        }
        L = _mm512_mask_sub_epi8(
            L, swap, _mm512_set1_epi8(static_cast<char>(nn + 1)), L);
        binv = _mm512_mask_mov_epi8(binv, swap, dinv);
        for (int i = dmax + 1 < kEcc ? dmax + 1 : kEcc; i >= 1; --i)
            B[i] = B[i - 1];
        B[0] = zero;
    }
    __mmask64 fail =
        _mm512_cmpgt_epu8_mask(L, _mm512_set1_epi8(kEcc / 2));

    // deg(C) <= L per lane, so locator terms above the max L over still-valid
    // lanes are zero everywhere that matters — cap the Chien loops there.
    // (Failed lanes' roots/errcnt are garbage either way; their corrections
    // are masked out and `fail` is already latched.)
    const __m512i lok = _mm512_maskz_mov_epi8(~fail, L);
    __m256i hm = _mm256_max_epu8(_mm512_castsi512_si256(lok),
                                 _mm512_extracti64x4_epi64(lok, 1));
    __m128i hx = _mm_max_epu8(_mm256_castsi256_si128(hm),
                              _mm256_extracti128_si256(hm, 1));
    hx = _mm_max_epu8(hx, _mm_srli_si128(hx, 8));
    hx = _mm_max_epu8(hx, _mm_srli_si128(hx, 4));
    hx = _mm_max_epu8(hx, _mm_srli_si128(hx, 2));
    hx = _mm_max_epu8(hx, _mm_srli_si128(hx, 1));
    const int lmax = _mm_extract_epi8(hx, 0) & 0xFF;

    // omega = (S * C) mod x^ecc (everything still in the 0x11b domain).
    // The key identity S(x)C(x) = omega(x) mod x^ecc guarantees
    // deg(omega) < L for every correctable lane, so only coefficients
    // below lmax are ever nonzero where they matter — build (and later
    // evaluate) just those: at the worst case L=16 this halves the Forney
    // numerator work, and at L=8 it cuts it 4x.
    const int wmax = lmax > 0 ? lmax : 1;
    __m512i W[kEcc];
    for (int k = 0; k < wmax; ++k) {
        __m512i acc = S[k];
        for (int i = 1; i <= k; ++i)
            acc = _mm512_xor_si512(acc, gfmul(C[i], S[k - i]));
        W[k] = acc;
    }

    // Chien sweep: q[deg] = C[deg] * alpha^{-j deg} updates incrementally per
    // lag j.  At a root (sum q == 0): e = omega(X^-1) / sum_{odd deg} q[deg]
    // — the X^{+-1} factors of the textbook Forney cancel against the
    // derivative's X^{-(deg-1)}, leaving a pure ratio.  omega(X^-1) is only
    // needed at the <= t roots per tile, so it is evaluated on demand from
    // the static W with host-scalar powers instead of tracking 32 more
    // running vectors through all 255 steps.
    __m512i q[kEcc + 1], errcnt = zero;
    for (int i = 0; i <= kEcc; ++i) q[i] = C[i];
    for (int j = 0; j < kN; ++j) {
        if (j) {
            for (int i = 1; i <= lmax; ++i) q[i] = gfmulc(q[i], T.chien_c11b[i]);
        }
        __m512i val = q[0];
        for (int i = 1; i <= lmax; ++i) val = _mm512_xor_si512(val, q[i]);
        const __mmask64 root = _mm512_cmpeq_epi8_mask(val, zero);
        if (!root) continue;
        errcnt = _mm512_mask_add_epi8(errcnt, root, errcnt, one);
        // early exit: deg(C) <= L per lane, so a lane can have at most L
        // roots — once every non-failed lane has found all of them (errcnt
        // == L; failed lanes' roots are discarded anyway) the remaining
        // sweep cannot change any output.  Checked only on root hits
        // (<= t per tile), so the test is ~free; it pays off on
        // low-density tiles where the last root sits well before j=254.
        const __mmask64 pending =
            ~fail & _mm512_cmplt_epu8_mask(errcnt, L);
        if (!(root & ~fail)) {           // only failed lanes root here —
            if (!pending) break;         // their corrections are discarded
            continue;
        }
        __m512i oddsum = zero, num = W[0];
        for (int i = 1; i <= lmax; i += 2) oddsum = _mm512_xor_si512(oddsum, q[i]);
        for (int i = 1; i < wmax; ++i)
            num = _mm512_xor_si512(num, gfmulc(W[i], T.forney_pow[j][i]));
        fail |= root & _mm512_cmpeq_epi8_mask(oddsum, zero);
        const __mmask64 apply = root & ~fail;
        const __m512i mag = gfaff(gfmul(num, gfinv(oddsum)), T.psi_m);
        __m512i col = _mm512_load_si512(tile.cols[kN - 1 - j]);
        col = _mm512_xor_si512(col, _mm512_maskz_mov_epi8(apply, mag));
        _mm512_store_si512(tile.cols[kN - 1 - j], col);
        if (!(~fail & _mm512_cmplt_epu8_mask(errcnt, L))) break;
    }
    fail |= _mm512_cmpneq_epi8_mask(errcnt, L);
    for (int b = 0; b < n; ++b)
        ok[b] = static_cast<uint8_t>(!((fail >> b) & 1));
}

void decode_batch64(uint8_t* blocks, int n, uint8_t* ok) {
    static thread_local Tile tile;
    tile.load(blocks, n, kN, kN);
    alignas(64) uint8_t soa[kEcc][64];
    syndromes_from_tile(tile, soa);
    // ok fast path: a block with all-zero syndromes is already correct
    __m512i nz = _mm512_setzero_si512();
    for (int i = 0; i < kEcc; ++i)
        nz = _mm512_or_si512(nz, _mm512_load_si512(soa[i]));
    const __mmask64 bad =
        _mm512_test_epi8_mask(nz, _mm512_set1_epi8(static_cast<char>(0xFF)));
    if (!bad) {
        std::memset(ok, 1, static_cast<size_t>(n));
        return;
    }
    correct_batch64(tile, soa, n, ok);
    tile.store(blocks, n, kN, kN);
}

#endif  // RS_GFNI

}  // namespace

extern "C" {

// Blocks are independent: 64-block GFNI SoA tiles when the ISA allows
// (partial tiles zero-pad — zero blocks yield zero parity/syndromes),
// threaded with OpenMP.  The reference streams blocks sequentially on one
// core (/root/reference/src/utils.rs:97-180).

// in:  n_blocks * 223 bytes ; out: n_blocks * 255 bytes
void rs_encode_blocks(const uint8_t* in, int n_blocks, uint8_t* out) {
#ifdef RS_GFNI
    const int n_tiles = (n_blocks + 63) / 64;
#pragma omp parallel for schedule(static) if (n_tiles >= 2)
    for (int t = 0; t < n_tiles; ++t) {
        const int b0 = t * 64;
        const int n = n_blocks - b0 < 64 ? n_blocks - b0 : 64;
        encode_batch64(in + static_cast<size_t>(b0) * kK, n,
                       out + static_cast<size_t>(b0) * kN);
    }
#else
#pragma omp parallel for schedule(static) if (n_blocks >= 16)
    for (int i = 0; i < n_blocks; ++i)
        encode_one(in + i * kK, out + i * kN);
#endif
}

// Threads the batch loops may use: OpenMP's maximum where the library was
// built with it (native/Makefile drops -fopenmp where libgomp is missing),
// else 1.  Callers report it beside host-tail timings.
int rs_threads(void) {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

// Validates the GF(0x11d)->GF(0x11b) isomorphism tables and (when compiled
// with GFNI) the instruction conventions the batch decoder relies on.
// Returns 0 on success, a nonzero stage code on the first failure.
int rs_selftest(void) {
    for (int a = 0; a < 256; ++a)
        for (int b = 0; b < 256; ++b)
            if (T.to11b[gf_mul(static_cast<uint8_t>(a),
                               static_cast<uint8_t>(b))] !=
                Tables::mul11b(T.to11b[a], T.to11b[b]))
                return 1;                      // phi is not multiplicative
    for (int v = 0; v < 256; ++v)
        if (T.from11b[T.to11b[v]] != v) return 2;   // phi not a bijection
#ifdef RS_GFNI
    alignas(64) uint8_t in[64], out[64];
    for (int i = 0; i < 64; ++i)
        in[i] = static_cast<uint8_t>(i * 37 + 1);   // nonzero for i < 64
    const __m512i x = _mm512_load_si512(in);
    _mm512_store_si512(out, gfaff(x, T.phi_m));
    for (int i = 0; i < 64; ++i)
        if (out[i] != T.to11b[in[i]]) return 3;     // affine row convention
    _mm512_store_si512(out, gfinv(gfaff(x, T.phi_m)));
    for (int i = 0; i < 64; ++i)
        if (T.from11b[out[i]] != gf_inv(in[i])) return 4;  // 0x11b inverse
    _mm512_store_si512(out, gfmul(gfaff(x, T.phi_m),
                                  gfaff(_mm512_set1_epi8(7), T.phi_m)));
    for (int i = 0; i < 64; ++i)
        if (T.from11b[out[i]] != gf_mul(in[i], 7)) return 5;  // mulb field
#endif
    return 0;
}

// inout: n_blocks * 255 bytes (corrected in place); ok: n_blocks flags
void rs_decode_blocks(uint8_t* inout, int n_blocks, uint8_t* ok) {
#ifdef RS_GFNI
    const int n_tiles = (n_blocks + 63) / 64;
#pragma omp parallel for schedule(static) if (n_tiles >= 2)
    for (int t = 0; t < n_tiles; ++t) {
        const int b0 = t * 64;
        const int n = n_blocks - b0 < 64 ? n_blocks - b0 : 64;
        decode_batch64(inout + static_cast<size_t>(b0) * kN, n, ok + b0);
    }
#else
#pragma omp parallel for schedule(static) if (n_blocks >= 16)
    for (int i = 0; i < n_blocks; ++i)
        ok[i] = static_cast<uint8_t>(decode_one(inout + i * kN));
#endif
}

}  // extern "C"
