/* Fixed-base comb scalar multiplication over the twisted-Edwards form of
 * Curve25519, used to amortize X25519 work across a batch of sealed boxes
 * (sda_tpu_torch's copy of sda_tpu/native/curve25519_comb.c).
 *
 * Why this exists: a sealed box spends ~95% of its time in two Montgomery-
 * ladder scalarmults (ephemeral keygen + shared secret).  The ladder cannot
 * share work between messages.  When a batch seals many messages to the
 * SAME recipient key, both scalarmults become fixed-base: the base point G
 * is fixed forever, and the recipient point is fixed for the whole batch.
 * A radix-16 signed comb table (64 digit rows x 8 odd multiples) turns each
 * 255-bit scalarmult into 64 mixed additions with no doublings, ~3-4x less
 * field work than the ladder.
 *
 * Wire compatibility: outputs are X25519 u-coordinates, bit-identical to
 * crypto_scalarmult()/crypto_scalarmult_base() for the same inputs (the
 * Edwards<->Montgomery birational map preserves u regardless of the x-sign
 * chosen when lifting).  The sealing code composes them with the HSalsa20 /
 * XSalsa20-Poly1305 of sodium_prims.c, so sealed boxes remain openable by
 * crypto_box_seal_open.
 *
 * Constant-time posture: table lookups scan all entries with arithmetic
 * masks (no secret-indexed loads); digit recoding and conditional negation
 * are branch-free.  Field ops are the standard 51-bit-limb ref10 shapes.
 *
 * tests/test_torch_native.py holds every sealed box and shared secret built
 * from these functions against crypto/sodium.py's Python X25519 and against
 * libsodium.
 */

#include <stdint.h>
#include <string.h>

typedef struct { uint64_t v[5]; } fe; /* GF(2^255-19), 51-bit limbs */

#define MASK51 ((1ULL << 51) - 1)

static const fe fe_d2 = {{0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL,
                          0x6738cc7407977ULL, 0x2406d9dc56dffULL}};
static const fe fe_d = {{0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL,
                         0x739c663a03cbbULL, 0x52036cee2b6ffULL}};
static const fe fe_sqrtm1 = {{0x61b274a0ea0b0ULL, 0x0d5a5fc8f189dULL, 0x7ef5e9cbd0c60ULL,
                              0x78595a6804c9eULL, 0x2b8324804fc1dULL}};
static const fe fe_basex = {{0x62d608f25d51aULL, 0x412a4b4f6592aULL, 0x75b7171a4b31dULL,
                             0x1ff60527118feULL, 0x216936d3cd6e5ULL}};
static const fe fe_basey = {{0x6666666666658ULL, 0x4ccccccccccccULL, 0x1999999999999ULL,
                             0x3333333333333ULL, 0x6666666666666ULL}};

static void fe_0(fe *h) { memset(h, 0, sizeof *h); }
static void fe_1(fe *h) { fe_0(h); h->v[0] = 1; }

static void fe_add(fe *h, const fe *f, const fe *g)
{
    int i;
    for (i = 0; i < 5; i++) h->v[i] = f->v[i] + g->v[i];
}

/* h = f - g + 4p: the 4p bias keeps limbs positive even when g holds
 * uncarried sums (limbs up to ~2^53), which the add formulas produce */
static void fe_sub(fe *h, const fe *f, const fe *g)
{
    h->v[0] = f->v[0] + 0x1FFFFFFFFFFFB4ULL - g->v[0];
    h->v[1] = f->v[1] + 0x1FFFFFFFFFFFFCULL - g->v[1];
    h->v[2] = f->v[2] + 0x1FFFFFFFFFFFFCULL - g->v[2];
    h->v[3] = f->v[3] + 0x1FFFFFFFFFFFFCULL - g->v[3];
    h->v[4] = f->v[4] + 0x1FFFFFFFFFFFFCULL - g->v[4];
}

static void fe_neg(fe *h, const fe *f)
{
    fe zero; fe_0(&zero);
    fe_sub(h, &zero, f);
}

static void fe_cmov(fe *f, const fe *g, uint64_t mask)
{
    int i;
    for (i = 0; i < 5; i++) f->v[i] = (f->v[i] & ~mask) | (g->v[i] & mask);
}

/* branch-free swap of f and g when swap == 1 (must be 0 or 1) */
static void fe_cswap(fe *f, fe *g, uint64_t swap)
{
    uint64_t mask = (uint64_t)0 - swap;
    int i;
    for (i = 0; i < 5; i++) {
        uint64_t x = (f->v[i] ^ g->v[i]) & mask;
        f->v[i] ^= x;
        g->v[i] ^= x;
    }
}

/* h = 121666 * f, carried.  Inputs may carry the 4p-biased magnitudes the
 * sub/add formulas produce (limbs < 2^54): 2^54 * 121666 < 2^71 per limb
 * fits __uint128_t with room to spare. */
static void fe_mul121666(fe *h, const fe *f)
{
    __uint128_t r;
    uint64_t c, h0, h1, h2, h3, h4;
    r = (__uint128_t)f->v[0] * 121666;     h0 = (uint64_t)r & MASK51; c = (uint64_t)(r >> 51);
    r = (__uint128_t)f->v[1] * 121666 + c; h1 = (uint64_t)r & MASK51; c = (uint64_t)(r >> 51);
    r = (__uint128_t)f->v[2] * 121666 + c; h2 = (uint64_t)r & MASK51; c = (uint64_t)(r >> 51);
    r = (__uint128_t)f->v[3] * 121666 + c; h3 = (uint64_t)r & MASK51; c = (uint64_t)(r >> 51);
    r = (__uint128_t)f->v[4] * 121666 + c; h4 = (uint64_t)r & MASK51; c = (uint64_t)(r >> 51);
    h0 += 19 * c;
    h->v[0] = h0; h->v[1] = h1; h->v[2] = h2; h->v[3] = h3; h->v[4] = h4;
}

static void fe_mul(fe *h, const fe *f, const fe *g)
{
    uint64_t f0 = f->v[0], f1 = f->v[1], f2 = f->v[2], f3 = f->v[3], f4 = f->v[4];
    uint64_t g0 = g->v[0], g1 = g->v[1], g2 = g->v[2], g3 = g->v[3], g4 = g->v[4];
    uint64_t g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3, g4_19 = 19 * g4;
    __uint128_t r0, r1, r2, r3, r4;
    uint64_t c, h0, h1, h2, h3, h4;

    r0 = (__uint128_t)f0 * g0 + (__uint128_t)f1 * g4_19 + (__uint128_t)f2 * g3_19
       + (__uint128_t)f3 * g2_19 + (__uint128_t)f4 * g1_19;
    r1 = (__uint128_t)f0 * g1 + (__uint128_t)f1 * g0 + (__uint128_t)f2 * g4_19
       + (__uint128_t)f3 * g3_19 + (__uint128_t)f4 * g2_19;
    r2 = (__uint128_t)f0 * g2 + (__uint128_t)f1 * g1 + (__uint128_t)f2 * g0
       + (__uint128_t)f3 * g4_19 + (__uint128_t)f4 * g3_19;
    r3 = (__uint128_t)f0 * g3 + (__uint128_t)f1 * g2 + (__uint128_t)f2 * g1
       + (__uint128_t)f3 * g0 + (__uint128_t)f4 * g4_19;
    r4 = (__uint128_t)f0 * g4 + (__uint128_t)f1 * g3 + (__uint128_t)f2 * g2
       + (__uint128_t)f3 * g1 + (__uint128_t)f4 * g0;

    c = (uint64_t)(r0 >> 51); h0 = (uint64_t)r0 & MASK51; r1 += c;
    c = (uint64_t)(r1 >> 51); h1 = (uint64_t)r1 & MASK51; r2 += c;
    c = (uint64_t)(r2 >> 51); h2 = (uint64_t)r2 & MASK51; r3 += c;
    c = (uint64_t)(r3 >> 51); h3 = (uint64_t)r3 & MASK51; r4 += c;
    c = (uint64_t)(r4 >> 51); h4 = (uint64_t)r4 & MASK51;
    h0 += 19 * c;
    c = h0 >> 51; h0 &= MASK51; h1 += c;
    c = h1 >> 51; h1 &= MASK51; h2 += c;
    h->v[0] = h0; h->v[1] = h1; h->v[2] = h2; h->v[3] = h3; h->v[4] = h4;
}

static void fe_sq(fe *h, const fe *f)
{
    fe_mul(h, f, f);
}

static void fe_sqn(fe *h, const fe *f, int n)
{
    int i;
    fe_sq(h, f);
    for (i = 1; i < n; i++) fe_sq(h, h);
}

/* z^(2^250 - 1), the shared prefix of the inversion and sqrt chains */
static void fe_pow250m1(fe *out, fe *t0_out, const fe *z)
{
    fe t0, t1, t2, t3;
    fe_sq(&t0, z);                      /* 2 */
    fe_sqn(&t1, &t0, 2);                /* 8 */
    fe_mul(&t1, z, &t1);                /* 9 */
    fe_mul(&t0, &t0, &t1);              /* 11 */
    fe_sq(&t2, &t0);                    /* 22 */
    fe_mul(&t1, &t1, &t2);              /* 2^5-1 */
    fe_sqn(&t2, &t1, 5);  fe_mul(&t1, &t2, &t1);   /* 2^10-1 */
    fe_sqn(&t2, &t1, 10); fe_mul(&t2, &t2, &t1);   /* 2^20-1 */
    fe_sqn(&t3, &t2, 20); fe_mul(&t2, &t3, &t2);   /* 2^40-1 */
    fe_sqn(&t2, &t2, 10); fe_mul(&t1, &t2, &t1);   /* 2^50-1 */
    fe_sqn(&t2, &t1, 50); fe_mul(&t2, &t2, &t1);   /* 2^100-1 */
    fe_sqn(&t3, &t2, 100); fe_mul(&t2, &t3, &t2);  /* 2^200-1 */
    fe_sqn(&t2, &t2, 50); fe_mul(&t1, &t2, &t1);   /* 2^250-1 */
    *out = t1;
    *t0_out = t0; /* z^11, needed by the inversion tail */
}

static void fe_invert(fe *out, const fe *z)
{
    fe t1, t0;
    fe_pow250m1(&t1, &t0, z);
    fe_sqn(&t1, &t1, 5);        /* 2^255 - 2^5 */
    fe_mul(out, &t1, &t0);      /* 2^255 - 21 = p - 2 */
}

/* z^((p-5)/8) = z^(2^252 - 3) */
static void fe_pow22523(fe *out, const fe *z)
{
    fe t1, t0;
    fe_pow250m1(&t1, &t0, z);
    fe_sqn(&t1, &t1, 2);        /* 2^252 - 4 */
    fe_mul(out, &t1, z);        /* 2^252 - 3 */
}

static void fe_carry_full(fe *h)
{
    uint64_t c;
    int pass;
    for (pass = 0; pass < 2; pass++) {
        c = h->v[0] >> 51; h->v[0] &= MASK51; h->v[1] += c;
        c = h->v[1] >> 51; h->v[1] &= MASK51; h->v[2] += c;
        c = h->v[2] >> 51; h->v[2] &= MASK51; h->v[3] += c;
        c = h->v[3] >> 51; h->v[3] &= MASK51; h->v[4] += c;
        c = h->v[4] >> 51; h->v[4] &= MASK51; h->v[0] += 19 * c;
    }
}

static void fe_tobytes(unsigned char *s, const fe *f)
{
    fe t = *f;
    uint64_t q, c;
    int i;
    fe_carry_full(&t);
    /* canonical: add 19, see if it overflows 2^255 */
    q = (t.v[0] + 19) >> 51;
    q = (t.v[1] + q) >> 51;
    q = (t.v[2] + q) >> 51;
    q = (t.v[3] + q) >> 51;
    q = (t.v[4] + q) >> 51;
    t.v[0] += 19 * q;
    c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
    c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
    c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
    c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
    t.v[4] &= MASK51;
    for (i = 0; i < 32; i++) {
        int limb = (i * 8) / 51, off = (i * 8) % 51;
        uint64_t b = t.v[limb] >> off;
        if (limb < 4 && off > 43) b |= t.v[limb + 1] << (51 - off);
        s[i] = (unsigned char)b;
    }
}

static void fe_frombytes(fe *h, const unsigned char *s)
{
    uint64_t lo, hi;
    memcpy(&lo, s, 8);      h->v[0] = lo & MASK51;
    memcpy(&hi, s + 6, 8);  h->v[1] = (hi >> 3) & MASK51;
    memcpy(&lo, s + 12, 8); h->v[2] = (lo >> 6) & MASK51;
    memcpy(&hi, s + 19, 8); h->v[3] = (hi >> 1) & MASK51;
    /* bit 255 (top of byte 31) falls outside the 51-bit mask: X25519 ignores it */
    memcpy(&lo, s + 24, 8); h->v[4] = (lo >> 12) & MASK51;
}

static int fe_iszero(const fe *f)
{
    unsigned char s[32];
    unsigned char acc = 0;
    int i;
    fe_tobytes(s, f);
    for (i = 0; i < 32; i++) acc |= s[i];
    return acc == 0;
}

static int fe_eq(const fe *f, const fe *g)
{
    unsigned char a[32], b[32];
    fe_tobytes(a, f);
    fe_tobytes(b, g);
    return memcmp(a, b, 32) == 0;
}

/* ---- group ops: a=-1 twisted Edwards, extended coordinates ---- */

typedef struct { fe X, Y, Z, T; } ge_p3;              /* T = XY/Z */
typedef struct { fe ypx, ymx, t2d; } ge_niels;        /* affine: y+x, y-x, 2dxy */

static void ge_identity(ge_p3 *h)
{
    fe_0(&h->X); fe_1(&h->Y); fe_1(&h->Z); fe_0(&h->T);
}

/* h = p + q, q in affine Niels form (add-2008-hwcd-3, 7M) */
static void ge_madd(ge_p3 *h, const ge_p3 *p, const ge_niels *q)
{
    fe A, B, C, D, E, F, G, H, t;
    fe_sub(&t, &p->Y, &p->X); fe_mul(&A, &t, &q->ymx);
    fe_add(&t, &p->Y, &p->X); fe_mul(&B, &t, &q->ypx);
    fe_mul(&C, &q->t2d, &p->T);
    fe_add(&D, &p->Z, &p->Z);
    fe_sub(&E, &B, &A);
    fe_sub(&F, &D, &C);
    fe_add(&G, &D, &C);
    fe_add(&H, &B, &A);
    fe_mul(&h->X, &E, &F);
    fe_mul(&h->Y, &G, &H);
    fe_mul(&h->T, &E, &H);
    fe_mul(&h->Z, &F, &G);
}

/* h = p + q, both extended (add-2008-hwcd-3 with Z2 != 1; table build only) */
static void ge_add(ge_p3 *h, const ge_p3 *p, const ge_p3 *q)
{
    fe A, B, C, D, E, F, G, H, t, u;
    fe_sub(&t, &p->Y, &p->X); fe_sub(&u, &q->Y, &q->X); fe_mul(&A, &t, &u);
    fe_add(&t, &p->Y, &p->X); fe_add(&u, &q->Y, &q->X); fe_mul(&B, &t, &u);
    fe_mul(&C, &p->T, &q->T); fe_mul(&C, &C, &fe_d2);
    fe_mul(&D, &p->Z, &q->Z); fe_add(&D, &D, &D);
    fe_sub(&E, &B, &A);
    fe_sub(&F, &D, &C);
    fe_add(&G, &D, &C);
    fe_add(&H, &B, &A);
    fe_mul(&h->X, &E, &F);
    fe_mul(&h->Y, &G, &H);
    fe_mul(&h->T, &E, &H);
    fe_mul(&h->Z, &F, &G);
}

/* h = 2p (dbl-2008-hwcd, a=-1: D=-A) */
static void ge_dbl(ge_p3 *h, const ge_p3 *p)
{
    fe A, B, C, D, E, F, G, H, t;
    fe_sq(&A, &p->X);
    fe_sq(&B, &p->Y);
    fe_sq(&C, &p->Z); fe_add(&C, &C, &C);
    fe_neg(&D, &A);
    fe_add(&t, &p->X, &p->Y); fe_sq(&t, &t);
    fe_sub(&E, &t, &A); fe_sub(&E, &E, &B);
    fe_add(&G, &D, &B);
    fe_sub(&F, &G, &C);
    fe_sub(&H, &D, &B);
    fe_mul(&h->X, &E, &F);
    fe_mul(&h->Y, &G, &H);
    fe_mul(&h->T, &E, &H);
    fe_mul(&h->Z, &F, &G);
}

/* ---- comb table: T[i][j] = (j+1) * 16^i * P in Niels form ---- */

#define COMB_DIGITS 64
#define COMB_WIDTH 8

typedef struct {
    ge_niels t[COMB_DIGITS][COMB_WIDTH];
} comb_table;

/* build the table from an extended point; one batched inversion at the end */
static void comb_table_from_p3(comb_table *tab, const ge_p3 *p)
{
    static const int N = COMB_DIGITS * COMB_WIDTH;
    ge_p3 rows[COMB_DIGITS * COMB_WIDTH];
    fe zs[COMB_DIGITS * COMB_WIDTH], zinvs[COMB_DIGITS * COMB_WIDTH], acc, accinv;
    ge_p3 row;
    int i, j;

    row = *p;
    for (i = 0; i < COMB_DIGITS; i++) {
        rows[i * COMB_WIDTH] = row;
        for (j = 1; j < COMB_WIDTH; j++)
            ge_add(&rows[i * COMB_WIDTH + j], &rows[i * COMB_WIDTH + j - 1], &row);
        if (i + 1 < COMB_DIGITS) {
            ge_dbl(&row, &row); ge_dbl(&row, &row);
            ge_dbl(&row, &row); ge_dbl(&row, &row);
        }
    }
    /* Montgomery batch inversion of all Z coordinates */
    fe_1(&acc);
    for (i = 0; i < N; i++) {
        zs[i] = acc;
        fe_mul(&acc, &acc, &rows[i].Z);
    }
    fe_invert(&accinv, &acc);
    for (i = N - 1; i >= 0; i--) {
        fe_mul(&zinvs[i], &zs[i], &accinv);
        fe_mul(&accinv, &accinv, &rows[i].Z);
    }
    for (i = 0; i < COMB_DIGITS; i++) {
        for (j = 0; j < COMB_WIDTH; j++) {
            fe x, y, xy;
            ge_niels *n = &tab->t[i][j];
            fe_mul(&x, &rows[i * COMB_WIDTH + j].X, &zinvs[i * COMB_WIDTH + j]);
            fe_mul(&y, &rows[i * COMB_WIDTH + j].Y, &zinvs[i * COMB_WIDTH + j]);
            fe_add(&n->ypx, &y, &x);
            fe_sub(&n->ymx, &y, &x);
            fe_carry_full(&n->ypx);
            fe_carry_full(&n->ymx);
            fe_mul(&xy, &x, &y);
            fe_mul(&n->t2d, &xy, &fe_d2);
        }
    }
}

/* comb table for the fixed base point G (built once, lazily) */
void sda_comb_table_base(comb_table *tab)
{
    ge_p3 B;
    B.X = fe_basex; B.Y = fe_basey; fe_1(&B.Z);
    fe_mul(&B.T, &fe_basex, &fe_basey);
    comb_table_from_p3(tab, &B);
}

/* Lift an X25519 public key (Montgomery u) to an Edwards point.  Returns 0
 * on success, -1 if u does not lift to a curve point (the caller then seals
 * item by item on the ladder). */
static int comb_lift_u(ge_p3 *p, const unsigned char u_bytes[32])
{
    fe u, num, den, deninv, y, y2, xnum, xden, x, x2, chk, t, xd7, xd3;

    fe_frombytes(&u, u_bytes);
    /* y = (u-1)/(u+1) */
    fe one; fe_1(&one);
    fe_sub(&num, &u, &one);
    fe_add(&den, &u, &one);
    if (fe_iszero(&den)) return -1; /* u = -1: order-4 point */
    fe_invert(&deninv, &den);
    fe_mul(&y, &num, &deninv);
    /* x^2 = (y^2 - 1) / (d y^2 + 1) */
    fe_sq(&y2, &y);
    fe_sub(&xnum, &y2, &one);
    fe_mul(&xden, &y2, &fe_d);
    fe_add(&xden, &xden, &one);
    /* x = xnum * xden^3 * (xnum * xden^7)^((p-5)/8) */
    fe_sq(&t, &xden); fe_mul(&xd3, &t, &xden);      /* xden^3 */
    fe_sq(&t, &xd3); fe_mul(&xd7, &t, &xden);       /* xden^7 */
    fe_mul(&t, &xnum, &xd7);
    fe_pow22523(&t, &t);
    fe_mul(&x, &xnum, &xd3);
    fe_mul(&x, &x, &t);
    /* verify: xden * x^2 == +-xnum */
    fe_sq(&x2, &x);
    fe_mul(&chk, &x2, &xden);
    if (!fe_eq(&chk, &xnum)) {
        fe_mul(&x, &x, &fe_sqrtm1);
        fe_sq(&x2, &x);
        fe_mul(&chk, &x2, &xden);
        if (!fe_eq(&chk, &xnum)) return -1; /* not on curve */
    }
    p->X = x; p->Y = y; fe_1(&p->Z);
    fe_mul(&p->T, &x, &y);
    return 0;
}

/* Lift u and build its comb table: 0 on success, -1 if u does not lift. */
int sda_comb_table_from_u(comb_table *tab, const unsigned char u_bytes[32])
{
    ge_p3 p;
    if (comb_lift_u(&p, u_bytes) != 0) return -1;
    comb_table_from_p3(tab, &p);
    return 0;
}

/* 1 when u lifts to a curve point (a comb table can be built for it) */
int sda_comb_lifts(const unsigned char u_bytes[32])
{
    ge_p3 p;
    return comb_lift_u(&p, u_bytes) == 0;
}

/* recode a 255-bit scalar into 64 signed radix-16 digits in [-8, 8] */
static void comb_recode(signed char e[COMB_DIGITS], const unsigned char s[32])
{
    int i;
    signed char carry = 0;
    for (i = 0; i < 32; i++) {
        e[2 * i] = s[i] & 15;
        e[2 * i + 1] = (s[i] >> 4) & 15;
    }
    for (i = 0; i < COMB_DIGITS - 1; i++) {
        e[i] = (signed char)(e[i] + carry);
        carry = (signed char)((e[i] + 8) >> 4);
        e[i] = (signed char)(e[i] - (carry << 4));
    }
    e[COMB_DIGITS - 1] = (signed char)(e[COMB_DIGITS - 1] + carry);
}

static uint64_t ct_eq_u64(uint64_t a, uint64_t b)
{
    uint64_t x = a ^ b;
    return (uint64_t)0 - (uint64_t)((x | (0 - x)) >> 63 ^ 1);
}

static void niels_select(ge_niels *out, const ge_niels row[COMB_WIDTH], signed char digit)
{
    uint64_t babs = (uint64_t)(digit < 0 ? -digit : digit);
    uint64_t negmask = (uint64_t)0 - (uint64_t)(digit < 0);
    fe negt2d, tmp;
    int j;
    fe_1(&out->ypx); fe_1(&out->ymx); fe_0(&out->t2d); /* identity */
    for (j = 0; j < COMB_WIDTH; j++) {
        uint64_t mask = ct_eq_u64(babs, (uint64_t)(j + 1));
        fe_cmov(&out->ypx, &row[j].ypx, mask);
        fe_cmov(&out->ymx, &row[j].ymx, mask);
        fe_cmov(&out->t2d, &row[j].t2d, mask);
    }
    /* conditional negation: swap ypx/ymx, negate t2d */
    tmp = out->ypx;
    fe_cmov(&out->ypx, &out->ymx, negmask);
    fe_cmov(&out->ymx, &tmp, negmask);
    fe_neg(&negt2d, &out->t2d);
    fe_carry_full(&negt2d);
    fe_cmov(&out->t2d, &negt2d, negmask);
}

/* scalar * table-point as a projective Montgomery-u fraction:
 * u = (Z + Y) / (Z - Y).  Numerator/denominator are returned separately so
 * callers can batch-invert across many results. */
void sda_comb_scalarmult_frac(fe *unum, fe *uden, const comb_table *tab,
                              const unsigned char scalar[32])
{
    signed char e[COMB_DIGITS];
    ge_p3 acc;
    ge_niels sel;
    int i;
    comb_recode(e, scalar);
    ge_identity(&acc);
    for (i = 0; i < COMB_DIGITS; i++) {
        niels_select(&sel, tab->t[i], e[i]);
        ge_madd(&acc, &acc, &sel);
    }
    fe_add(unum, &acc.Z, &acc.Y);
    fe_sub(uden, &acc.Z, &acc.Y);
}

/* batch-finalize: out[i] = num[i]/den[i] as 32 little-endian bytes via one
 * Montgomery batch inversion.  A zero denominator (the identity point)
 * yields all-zero bytes, matching the Montgomery ladder's encoding of the
 * point at infinity.  num/den are consumed as scratch; `scratch` must hold
 * n field elements. */
void sda_comb_finalize_u(unsigned char *out /* n*32 */, fe *num, fe *den,
                         fe *scratch, int n)
{
    fe acc, accinv;
    int i;
    fe_1(&acc);
    for (i = 0; i < n; i++) {
        if (fe_iszero(&den[i])) {
            fe_1(&den[i]);
            fe_0(&num[i]); /* identity encodes as zero bytes */
        }
        scratch[i] = acc;
        fe_mul(&acc, &acc, &den[i]);
    }
    fe_invert(&accinv, &acc);
    for (i = n - 1; i >= 0; i--) {
        fe dinv, u;
        fe_mul(&dinv, &scratch[i], &accinv);
        fe_mul(&accinv, &accinv, &den[i]);
        fe_mul(&u, &num[i], &dinv);
        fe_tobytes(out + 32 * (size_t)i, &u);
    }
}

/* ---- Montgomery ladder with deferred inversion ----
 *
 * The comb tables above only help FIXED-base scalarmults.  Opening a
 * batch of sealed boxes is the opposite shape: every ciphertext carries a
 * DIFFERENT ephemeral public key, and the recipient computes sk * epk_i —
 * a variable-base scalarmult per item that no table can amortize.  What
 * CAN be amortized is the final projective-to-affine division: the ladder
 * ends with u = X2/Z2, and libsodium pays a full field inversion (~254
 * squarings) per call.  This variant returns the (X2, Z2) fraction so the
 * caller batch-inverts across the whole chunk via sda_comb_finalize_u —
 * one inversion total instead of one per ciphertext.
 *
 * Standard RFC 7748 ladder, ref10 operation ordering (the z2 term uses
 * the BB + 121666*E form, equal to AA + 121665*E since AA = BB + E).
 * The scalar is clamped here exactly as crypto_scalarmult does, so a
 * zero output fraction reproduces libsodium's all-zero shared secret for
 * small-order points (callers treat it as an open failure, matching
 * crypto_box_beforenm).  Constant-time: bit-masked cswap, no
 * secret-dependent branches or loads. */
void sda_x25519_ladder_frac(fe *xout, fe *zout, const unsigned char scalar[32],
                            const unsigned char point[32])
{
    unsigned char e[32];
    fe x1, x2, z2, x3, z3, tmp0, tmp1;
    int pos;
    uint64_t swap = 0, b;

    memcpy(e, scalar, 32);
    e[0] &= 248; e[31] &= 127; e[31] |= 64; /* X25519 clamp */
    fe_frombytes(&x1, point);
    fe_1(&x2); fe_0(&z2);
    x3 = x1;   fe_1(&z3);
    for (pos = 254; pos >= 0; --pos) {
        b = (uint64_t)(e[pos / 8] >> (pos & 7)) & 1;
        swap ^= b;
        fe_cswap(&x2, &x3, swap);
        fe_cswap(&z2, &z3, swap);
        swap = b;
        fe_sub(&tmp0, &x3, &z3);
        fe_sub(&tmp1, &x2, &z2);
        fe_add(&x2, &x2, &z2);
        fe_add(&z2, &x3, &z3);
        fe_mul(&z3, &tmp0, &x2);
        fe_mul(&z2, &z2, &tmp1);
        fe_sq(&tmp0, &tmp1);
        fe_sq(&tmp1, &x2);
        fe_add(&x3, &z3, &z2);
        fe_sub(&z2, &z3, &z2);
        fe_mul(&x2, &tmp1, &tmp0);
        fe_sub(&tmp1, &tmp1, &tmp0);
        fe_sq(&z2, &z2);
        fe_mul121666(&z3, &tmp1);
        fe_sq(&x3, &x3);
        fe_add(&tmp0, &tmp0, &z3);
        fe_mul(&z3, &x1, &z2);
        fe_mul(&z2, &tmp1, &tmp0);
    }
    fe_cswap(&x2, &x3, swap);
    fe_cswap(&z2, &z3, swap);
    *xout = x2;
    *zout = z2;
}

/* single-shot u-coordinate scalarmult (tests + small batches) */
void sda_comb_scalarmult_u(unsigned char out[32], const comb_table *tab,
                           const unsigned char scalar[32])
{
    fe num, den, deninv, u;
    sda_comb_scalarmult_frac(&num, &den, tab, scalar);
    if (fe_iszero(&den)) { memset(out, 0, 32); return; }
    fe_invert(&deninv, &den);
    fe_mul(&u, &num, &deninv);
    fe_tobytes(out, &u);
}
