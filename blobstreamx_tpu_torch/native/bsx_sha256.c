/* Native host runtime for blobstreamx_tpu_torch: SHA-256 (FIPS 180-4),
 * Tendermint/RFC-6962 tuple trees, and the SHA-STARK execution-trace fill
 * (the host "data loader" that feeds the device prover).
 *
 * Implemented from the FIPS 180-4 specification; constants derived from
 * prime cube/square roots (the same derivation as the Python golden model,
 * giving an independent oracle) once, when the library is loaded.
 *
 * Exposed C ABI (loaded from Python via ctypes, see
 * blobstreamx_tpu_torch/native/__init__.py, which builds this file):
 *   bsx_sha256(msg, len, out32)
 *   bsx_sha256_many(msgs, n, stride, len, out)      fixed-size batch
 *   bsx_tuple_root(heights, hashes32, n, out32)     data-commitment root
 *   bsx_sha_trace_fill(blocks, chain, n_blocks, trace, aux_w, aux_out)
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define MASK32 0xFFFFFFFFu

/* ------------------------------------------------------------------ consts */

static uint32_t K[64];
static uint32_t IV[8];

static int is_prime(int n) {
    for (int d = 2; d * d <= n; d++)
        if (n % d == 0) return 0;
    return n >= 2;
}

/* frac(root) * 2^32 via exact integer arithmetic: low 32 bits of
 * floor(root(p * 2^(32*k))) with k = 3 (cube) or 2 (square). p < 2^9 so the
 * search bounds keep every product inside __int128. */
static uint32_t frac_cbrt32(uint64_t p) {
    unsigned __int128 target = ((unsigned __int128)p) << 96;
    unsigned __int128 lo = 0, hi = ((unsigned __int128)1) << 36;
    while (lo + 1 < hi) {
        unsigned __int128 mid = (lo + hi) >> 1;
        if (mid * mid * mid > target)
            hi = mid;
        else
            lo = mid;
    }
    return (uint32_t)(lo & MASK32);
}

static uint32_t frac_sqrt32(uint64_t p) {
    unsigned __int128 target = ((unsigned __int128)p) << 64;
    unsigned __int128 lo = 0, hi = ((unsigned __int128)1) << 37;
    while (lo + 1 < hi) {
        unsigned __int128 mid = (lo + hi) >> 1;
        if (mid * mid > target)
            hi = mid;
        else
            lo = mid;
    }
    return (uint32_t)(lo & MASK32);
}

/* Runs when the library is loaded, before any entry point can be called, so
 * that threads calling in at once only ever read the tables. */
__attribute__((constructor)) static void init_consts(void) {
    int found = 0;
    for (int c = 2; found < 64; c++) {
        if (!is_prime(c)) continue;
        K[found] = frac_cbrt32((uint64_t)c);
        if (found < 8) IV[found] = frac_sqrt32((uint64_t)c);
        found++;
    }
}

/* ------------------------------------------------------------- compression */

static inline uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

static void schedule(const uint8_t *block, uint32_t w[64], uint64_t carr[64]) {
    for (int t = 0; t < 16; t++)
        w[t] = ((uint32_t)block[4 * t] << 24) | ((uint32_t)block[4 * t + 1] << 16) |
               ((uint32_t)block[4 * t + 2] << 8) | (uint32_t)block[4 * t + 3];
    for (int t = 16; t < 64; t++) {
        uint32_t s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3);
        uint32_t s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10);
        uint64_t full = (uint64_t)w[t - 16] + s0 + w[t - 7] + s1;
        w[t] = (uint32_t)full;
        if (carr) carr[t] = full >> 32;
    }
}

/* One compression; optionally records the per-round start states and the
 * carry values the STARK trace needs. */
static void compress(uint32_t state[8], const uint32_t w[64],
                     uint32_t (*states)[8], uint64_t *car_a, uint64_t *car_e,
                     uint64_t dg_carr[8]) {
    uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
    uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
    for (int t = 0; t < 64; t++) {
        if (states) {
            states[t][0] = a; states[t][1] = b; states[t][2] = c; states[t][3] = d;
            states[t][4] = e; states[t][5] = f; states[t][6] = g; states[t][7] = h;
        }
        uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint64_t t1 = (uint64_t)h + S1 + ch + K[t] + w[t];
        uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        uint64_t t2 = (uint64_t)S0 + maj;
        if (t < 63) {
            if (car_a) car_a[t + 1] = (t1 + t2) >> 32;
            if (car_e) car_e[t + 1] = ((uint64_t)d + t1) >> 32;
        } else if (dg_carr) {
            uint64_t fr[8];
            fr[0] = (uint64_t)state[0] + t1 + t2;
            fr[1] = (uint64_t)state[1] + a;
            fr[2] = (uint64_t)state[2] + b;
            fr[3] = (uint64_t)state[3] + c;
            fr[4] = (uint64_t)state[4] + d + t1;
            fr[5] = (uint64_t)state[5] + e;
            fr[6] = (uint64_t)state[6] + f;
            fr[7] = (uint64_t)state[7] + g;
            for (int j = 0; j < 8; j++) dg_carr[j] = fr[j] >> 32;
        }
        h = g; g = f; f = e; e = (uint32_t)(d + t1);
        d = c; c = b; b = a; a = (uint32_t)(t1 + t2);
    }
    state[0] += a; state[1] += b; state[2] += c; state[3] += d;
    state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

void bsx_sha256(const uint8_t *msg, size_t len, uint8_t out[32]) {
    uint32_t state[8];
    memcpy(state, IV, sizeof state);
    uint64_t bitlen = (uint64_t)len * 8;
    size_t full = len / 64;
    uint32_t w[64];
    for (size_t i = 0; i < full; i++) {
        schedule(msg + 64 * i, w, NULL);
        compress(state, w, NULL, NULL, NULL, NULL);
    }
    uint8_t tail[128];
    size_t rem = len - 64 * full;
    memcpy(tail, msg + 64 * full, rem);
    tail[rem] = 0x80;
    size_t tail_len = (rem + 1 + 8 <= 64) ? 64 : 128;
    memset(tail + rem + 1, 0, tail_len - rem - 1 - 8);
    for (int i = 0; i < 8; i++)
        tail[tail_len - 1 - i] = (uint8_t)(bitlen >> (8 * i));
    for (size_t i = 0; i < tail_len / 64; i++) {
        schedule(tail + 64 * i, w, NULL);
        compress(state, w, NULL, NULL, NULL, NULL);
    }
    for (int j = 0; j < 8; j++)
        for (int i = 0; i < 4; i++)
            out[4 * j + i] = (uint8_t)(state[j] >> (24 - 8 * i));
}

void bsx_sha256_many(const uint8_t *msgs, size_t n, size_t stride, size_t len,
                     uint8_t *out) {
    for (size_t i = 0; i < n; i++)
        bsx_sha256(msgs + i * stride, len, out + 32 * i);
}

/* -------------------------------------------------------------- tuple tree */

static void leaf_hash_tuple(uint64_t height, const uint8_t *dhash, uint8_t out[32]) {
    uint8_t msg[65];
    msg[0] = 0x00;
    memset(msg + 1, 0, 24);
    for (int i = 0; i < 8; i++) msg[25 + i] = (uint8_t)(height >> (56 - 8 * i));
    memcpy(msg + 33, dhash, 32);
    bsx_sha256(msg, 65, out);
}

static void inner_hash(const uint8_t *l, const uint8_t *r, uint8_t out[32]) {
    uint8_t msg[65];
    msg[0] = 0x01;
    memcpy(msg + 1, l, 32);
    memcpy(msg + 33, r, 32);
    bsx_sha256(msg, 65, out);
}

/* RFC 6962 split: largest power of two strictly less than n. */
static size_t split_point(size_t n) {
    size_t k = 1;
    while (k * 2 < n) k *= 2;
    return k;
}

static void subtree_root(const uint64_t *heights, const uint8_t *hashes32,
                         size_t lo, size_t hi, uint8_t out[32]) {
    if (hi - lo == 1) {
        leaf_hash_tuple(heights[lo], hashes32 + 32 * lo, out);
        return;
    }
    size_t k = split_point(hi - lo);
    uint8_t l[32], r[32];
    subtree_root(heights, hashes32, lo, lo + k, l);
    subtree_root(heights, hashes32, lo + k, hi, r);
    inner_hash(l, r, out);
}

void bsx_tuple_root(const uint64_t *heights, const uint8_t *hashes32, size_t n,
                    uint8_t out[32]) {
    if (n == 0) {
        bsx_sha256((const uint8_t *)"", 0, out);
        return;
    }
    subtree_root(heights, hashes32, 0, n, out);
}

/* ---------------------------------------------------- SHA-STARK trace fill */

/* Column layout — MUST mirror blobstreamx_tpu_torch/prover/sha_air.py. */
#define N_WIN 16
#define OFF_WIN 0
#define OFF_ST (OFF_WIN + 32 * N_WIN)
#define OFF_HIN (OFF_ST + 32 * 8)
#define OFF_DG (OFF_HIN + 32 * 8)
#define OFF_CAR (OFF_DG + 32 * 8)
#define N_COLS (OFF_CAR + 20)
#define CAR_SCHED 0
#define CAR_A 2
#define CAR_E 5
#define CAR_DGA 8
#define CAR_DGE 11
#define CAR_DG1 14
#define ROUNDS 64

static inline void put_word(uint64_t *row, int base, uint32_t w) {
    for (int i = 0; i < 32; i++) row[base + i] = (w >> i) & 1u;
}

/* blocks: n_blocks * 64 bytes; chain: n_blocks bytes (0/1);
 * trace: (64 * n_blocks) x N_COLS row-major uint64 (zero-initialised by the
 * caller); aux_w: n_blocks * 16 u32; aux_out: n_blocks * 8 u32. */
void bsx_sha_trace_fill(const uint8_t *blocks, const uint8_t *chain,
                        size_t n_blocks, uint64_t *trace, uint32_t *aux_w,
                        uint32_t *aux_out) {
    uint32_t state[8];
    memcpy(state, IV, sizeof state);
    /* win[j][row] = w_flat[row - j]: keep a circular buffer of the last
     * N_WIN schedule words as rows advance. */
    uint32_t ring[N_WIN];
    memset(ring, 0, sizeof ring);
    size_t ring_pos = 0, rows_done = 0;

    for (size_t b = 0; b < n_blocks; b++) {
        uint32_t w[64];
        uint64_t sched_carr[64];
        memset(sched_carr, 0, sizeof sched_carr);
        schedule(blocks + 64 * b, w, sched_carr);
        for (int t = 0; t < 16; t++) aux_w[16 * b + t] = w[t];

        if (!chain[b]) memcpy(state, IV, sizeof state);
        uint32_t hin[8];
        memcpy(hin, state, sizeof hin);

        uint32_t states[64][8];
        uint64_t car_a[64], car_e[64], dg_carr[8];
        memset(car_a, 0, sizeof car_a);
        memset(car_e, 0, sizeof car_e);
        compress(state, w, states, car_a, car_e, dg_carr);
        for (int j = 0; j < 8; j++) aux_out[8 * b + j] = state[j];

        for (int t = 0; t < ROUNDS; t++) {
            size_t row = rows_done + t;
            uint64_t *r = trace + row * N_COLS;
            /* window: j = 0 is w[t]; j >= 1 reaches back through the ring */
            ring[ring_pos] = w[t];
            for (int j = 0; j < N_WIN; j++) {
                size_t idx = (ring_pos + N_WIN - j) % N_WIN;
                uint32_t wv = (row >= (size_t)j) ? ring[idx] : 0;
                put_word(r, OFF_WIN + 32 * j, wv);
            }
            ring_pos = (ring_pos + 1) % N_WIN;
            for (int j = 0; j < 8; j++) {
                put_word(r, OFF_ST + 32 * j, states[t][j]);
                put_word(r, OFF_HIN + 32 * j, hin[j]);
            }
            r[OFF_CAR + CAR_SCHED] = sched_carr[t] & 1;
            r[OFF_CAR + CAR_SCHED + 1] = (sched_carr[t] >> 1) & 1;
            for (int i = 0; i < 3; i++) {
                r[OFF_CAR + CAR_A + i] = (car_a[t] >> i) & 1;
                r[OFF_CAR + CAR_E + i] = (car_e[t] >> i) & 1;
            }
            if (t == ROUNDS - 1) {
                for (int j = 0; j < 8; j++)
                    put_word(r, OFF_DG + 32 * j, state[j]);
                for (int i = 0; i < 3; i++) {
                    r[OFF_CAR + CAR_DGA + i] = (dg_carr[0] >> i) & 1;
                    r[OFF_CAR + CAR_DGE + i] = (dg_carr[4] >> i) & 1;
                }
                static const int slots[6] = {1, 2, 3, 5, 6, 7};
                for (int s = 0; s < 6; s++)
                    r[OFF_CAR + CAR_DG1 + s] = dg_carr[slots[s]] & 1;
            }
        }
        rows_done += ROUNDS;
    }
}
