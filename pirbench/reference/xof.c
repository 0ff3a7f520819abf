/* Serial TurboSHAKE128 for the benchmark's plain reference.
 *
 * One sponge: Keccak-p[1600, 12], rate 168 bytes, domain byte 0x1F,
 * written from the specification (RFC 9861) with each round's steps
 * spelt out lane by lane. The stream's 168-byte blocks are squeezed one
 * after another, each the permutation of the last, so a word deep in
 * the stream costs the squeeze of every block before it.
 *
 * Built by pirbench/reference/keccak.py with the host's C compiler and
 * called through ctypes, which lets go of the interpreter lock.
 */

#include <stdint.h>

#define RATE 168
#define RATE_WORDS (RATE / 4)
#define DOMAIN 0x1F
#define ROL(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

/* the last 12 of Keccak-f[1600]'s 24 round constants */
static const uint64_t RC[12] = {
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL, 0x8000000000008003ULL,
    0x8000000000008002ULL, 0x8000000000000080ULL, 0x000000000000800AULL, 0x800000008000000AULL,
    0x8000000080008081ULL, 0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static void permute(uint64_t s[25]) {
    uint64_t a0 = s[0], a1 = s[1], a2 = s[2], a3 = s[3], a4 = s[4];
    uint64_t a5 = s[5], a6 = s[6], a7 = s[7], a8 = s[8], a9 = s[9];
    uint64_t a10 = s[10], a11 = s[11], a12 = s[12], a13 = s[13], a14 = s[14];
    uint64_t a15 = s[15], a16 = s[16], a17 = s[17], a18 = s[18], a19 = s[19];
    uint64_t a20 = s[20], a21 = s[21], a22 = s[22], a23 = s[23], a24 = s[24];
    for (int r = 0; r < 12; r++) {
        /* theta */
        uint64_t c0 = a0 ^ a5 ^ a10 ^ a15 ^ a20;
        uint64_t c1 = a1 ^ a6 ^ a11 ^ a16 ^ a21;
        uint64_t c2 = a2 ^ a7 ^ a12 ^ a17 ^ a22;
        uint64_t c3 = a3 ^ a8 ^ a13 ^ a18 ^ a23;
        uint64_t c4 = a4 ^ a9 ^ a14 ^ a19 ^ a24;
        uint64_t d0 = c4 ^ ROL(c1, 1);
        uint64_t d1 = c0 ^ ROL(c2, 1);
        uint64_t d2 = c1 ^ ROL(c3, 1);
        uint64_t d3 = c2 ^ ROL(c4, 1);
        uint64_t d4 = c3 ^ ROL(c0, 1);
        /* rho and pi: b[y + 5 ((2x + 3y) mod 5)] = rot(a[x + 5y] ^ d[x]) */
        uint64_t b0 = a0 ^ d0;
        uint64_t b1 = ROL(a6 ^ d1, 44);
        uint64_t b2 = ROL(a12 ^ d2, 43);
        uint64_t b3 = ROL(a18 ^ d3, 21);
        uint64_t b4 = ROL(a24 ^ d4, 14);
        uint64_t b5 = ROL(a3 ^ d3, 28);
        uint64_t b6 = ROL(a9 ^ d4, 20);
        uint64_t b7 = ROL(a10 ^ d0, 3);
        uint64_t b8 = ROL(a16 ^ d1, 45);
        uint64_t b9 = ROL(a22 ^ d2, 61);
        uint64_t b10 = ROL(a1 ^ d1, 1);
        uint64_t b11 = ROL(a7 ^ d2, 6);
        uint64_t b12 = ROL(a13 ^ d3, 25);
        uint64_t b13 = ROL(a19 ^ d4, 8);
        uint64_t b14 = ROL(a20 ^ d0, 18);
        uint64_t b15 = ROL(a4 ^ d4, 27);
        uint64_t b16 = ROL(a5 ^ d0, 36);
        uint64_t b17 = ROL(a11 ^ d1, 10);
        uint64_t b18 = ROL(a17 ^ d2, 15);
        uint64_t b19 = ROL(a23 ^ d3, 56);
        uint64_t b20 = ROL(a2 ^ d2, 62);
        uint64_t b21 = ROL(a8 ^ d3, 55);
        uint64_t b22 = ROL(a14 ^ d4, 39);
        uint64_t b23 = ROL(a15 ^ d0, 41);
        uint64_t b24 = ROL(a21 ^ d1, 2);
        /* chi, then iota */
        a0 = b0 ^ (~b1 & b2) ^ RC[r];
        a1 = b1 ^ (~b2 & b3);
        a2 = b2 ^ (~b3 & b4);
        a3 = b3 ^ (~b4 & b0);
        a4 = b4 ^ (~b0 & b1);
        a5 = b5 ^ (~b6 & b7);
        a6 = b6 ^ (~b7 & b8);
        a7 = b7 ^ (~b8 & b9);
        a8 = b8 ^ (~b9 & b5);
        a9 = b9 ^ (~b5 & b6);
        a10 = b10 ^ (~b11 & b12);
        a11 = b11 ^ (~b12 & b13);
        a12 = b12 ^ (~b13 & b14);
        a13 = b13 ^ (~b14 & b10);
        a14 = b14 ^ (~b10 & b11);
        a15 = b15 ^ (~b16 & b17);
        a16 = b16 ^ (~b17 & b18);
        a17 = b17 ^ (~b18 & b19);
        a18 = b18 ^ (~b19 & b15);
        a19 = b19 ^ (~b15 & b16);
        a20 = b20 ^ (~b21 & b22);
        a21 = b21 ^ (~b22 & b23);
        a22 = b22 ^ (~b23 & b24);
        a23 = b23 ^ (~b24 & b20);
        a24 = b24 ^ (~b20 & b21);
    }
    s[0] = a0; s[1] = a1; s[2] = a2; s[3] = a3; s[4] = a4;
    s[5] = a5; s[6] = a6; s[7] = a7; s[8] = a8; s[9] = a9;
    s[10] = a10; s[11] = a11; s[12] = a12; s[13] = a13; s[14] = a14;
    s[15] = a15; s[16] = a16; s[17] = a17; s[18] = a18; s[19] = a19;
    s[20] = a20; s[21] = a21; s[22] = a22; s[23] = a23; s[24] = a24;
}

/* Rows of the stream read as little-endian u32 words, row_words to a
 * row: out[i * row_words + j] is word rows[i] * row_words + j of
 * TurboSHAKE128(seed). rows must rise strictly. Returns 0, or -1 for a
 * seed of more than one block or rows that do not rise. */
int ts128_stream_rows(const uint8_t *seed, int64_t seed_len, int64_t row_words, const int64_t *rows,
                      int64_t nrows, uint32_t *out) {
    uint64_t s[25] = {0};
    if (seed_len < 0 || seed_len + 1 >= RATE || row_words <= 0) return -1;
    for (int64_t i = 1; i < nrows; i++)
        if (rows[i] <= rows[i - 1]) return -1;
    if (nrows > 0 && rows[0] < 0) return -1;
    /* absorb seed || DOMAIN || 0... || 0x80 as one block */
    for (int64_t i = 0; i < seed_len; i++) s[i / 8] ^= (uint64_t)seed[i] << (8 * (i % 8));
    s[seed_len / 8] ^= (uint64_t)DOMAIN << (8 * (seed_len % 8));
    s[(RATE - 1) / 8] ^= (uint64_t)0x80 << (8 * ((RATE - 1) % 8));
    int64_t have = -1; /* the block the state holds; -1: none squeezed yet */
    for (int64_t i = 0; i < nrows; i++) {
        int64_t w = rows[i] * row_words, end = w + row_words;
        uint32_t *dst = out + i * row_words;
        while (w < end) {
            int64_t block = w / RATE_WORDS;
            while (have < block) {
                permute(s);
                have++;
            }
            for (int64_t j = w % RATE_WORDS; j < RATE_WORDS && w < end; j++, w++)
                *dst++ = (uint32_t)(s[j / 2] >> (32 * (j % 2)));
        }
    }
    return 0;
}
