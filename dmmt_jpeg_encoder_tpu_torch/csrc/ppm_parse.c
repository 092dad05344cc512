/* Native ASCII PPM (P3) tokenizer/parser.
 *
 * Host-native fast path for the byte-wise tokenizer loop that dominates
 * large P3 ingests (reference behavior: src/image/reader/ppm.rs:44-78).
 * Semantics matched:
 *   - whitespace = space \t \n \f \r (Rust u8::is_ascii_whitespace)
 *   - '#' starts a comment that runs to '\n' and does NOT terminate the
 *     token being accumulated (ppm.rs:49-58)
 *   - every token after the "P3" magic must parse as u16 (0..=65535)
 *
 * Returns the number of u16 values written to out (width, height, maxval,
 * then the color components), or:
 *   -1 output capacity exceeded, -2 token parse failure, -3 missing P3 magic.
 */

#include <stdint.h>
#include <stddef.h>

static inline int is_ws(uint8_t b) {
    return b == ' ' || b == '\t' || b == '\n' || b == '\f' || b == '\r';
}

long dmmt_parse_ppm(const uint8_t *data, long n, uint16_t *out, long cap) {
    long i = 0, count = 0;
    int in_comment = 0;
    int have_magic = 0;

    /* token accumulator: value for numeric tokens, plus raw-prefix check for magic */
    uint32_t value = 0;
    int token_len = 0;
    int token_bad = 0;
    uint8_t t0 = 0, t1 = 0;

    for (;;) {
        int end_of_input = (i >= n);
        uint8_t b = end_of_input ? ' ' : data[i];
        if (!end_of_input) {
            i++;
            if (in_comment) {
                if (b == '\n') in_comment = 0;
                continue;
            }
            if (b == '#') { in_comment = 1; continue; }
            if (!is_ws(b)) {
                if (token_len == 0) t0 = b;
                else if (token_len == 1) t1 = b;
                if (b >= '0' && b <= '9') {
                    value = value * 10u + (uint32_t)(b - '0');
                    if (value > 65535u) token_bad = 1;
                } else {
                    token_bad = 1;
                }
                token_len++;
                continue;
            }
        }
        /* whitespace or end: close any token */
        if (token_len > 0) {
            if (!have_magic) {
                if (token_len == 2 && t0 == 'P' && t1 == '3') {
                    have_magic = 1;
                } else {
                    return -3;
                }
            } else {
                if (token_bad) return -2;
                if (count >= cap) return -1;
                out[count++] = (uint16_t)value;
            }
            value = 0;
            token_len = 0;
            token_bad = 0;
        }
        if (end_of_input) break;
    }
    if (!have_magic) return -3;
    return count;
}

/* ---------------------------------------------------------------------------
 * Multithreaded P3 parser.
 *
 * The serial tokenizer above runs ~270 MB/s — that alone caps PPM->JPEG at
 * ~25 Mpix/s regardless of device speed. This variant splits the pixel
 * region across threads at whitespace-outside-comment boundaries (a token
 * can span a comment, including the comment's newline, so a bare '\n' is
 * NOT a safe split — the boundary scan first reaches a '\n' to leave any
 * comment, then advances to the first whitespace with comment tracking on).
 *
 * One parallel parse pass into worst-case-spaced per-chunk regions (a
 * value needs >= 2 input bytes, so a chunk of B bytes yields <= B/2+1
 * values), then a serial left-to-right memmove compaction — the compaction
 * touches only the actual output (~n/4 bytes) at memcpy speed, far cheaper
 * than re-scanning the input for exact counts.
 *
 * When the input contains no '#' at all (the common case), ANY whitespace
 * byte is a safe chunk boundary. With comments present, a boundary must be
 * whitespace OUTSIDE a comment; since a token may span a comment including
 * its newline, the scan first crosses a '\n' (leaving any comment) and
 * then tracks comment state to the next whitespace.
 *
 * Header (magic + width/height/maxval) is parsed serially up front into
 * hdr[3]; out receives ONLY the color samples, as u16 (elem_size 2) or u8
 * (elem_size 1, for maxval <= 255 sources: parse directly into the upload
 * dtype). Samples are validated against maxval in the parse loop.
 *
 * Returns the number of samples written, or a negative error:
 *   -1 capacity, -2 bad token, -3 missing magic, -4 value > maxval,
 *   -5 missing header tokens, -6 thread spawn failure.
 * Callers fall back to the (slow, precise-error) Python tokenizer on any
 * negative return.
 */

#include <pthread.h>
#include <stdlib.h>
#include <string.h>

/* Process-lifetime scratch for the spaced per-chunk regions: page faults
 * on a fresh ~n/2 buffer cost more than the parse itself on this host, so
 * the scratch is allocated once and reused (guarded by a mutex — the
 * parser is internally parallel anyway). */
static uint8_t *ppm_scratch = NULL;
static size_t ppm_scratch_size = 0;
static pthread_mutex_t ppm_scratch_lock = PTHREAD_MUTEX_INITIALIZER;

typedef struct {
    const uint8_t *data;
    long begin, end;        /* chunk byte range */
    void *out;              /* sample output base */
    long out_off;           /* sample index to start writing at */
    long cap;               /* total sample capacity */
    int elem_size;          /* 1 or 2 */
    uint32_t maxval;
    long count;             /* out: tokens counted / written */
    int err;                /* out: 0 or negative code */
} ppm_chunk_t;

static void *ppm_parse_worker(void *arg) {
    ppm_chunk_t *c = (ppm_chunk_t *)arg;
    const uint8_t *data = c->data;
    long i = c->begin, end = c->end;
    long idx = c->out_off;
    uint16_t *o16 = (uint16_t *)c->out;
    uint8_t *o8 = (uint8_t *)c->out;
    uint32_t value = 0, maxval = c->maxval;
    int len = 0, bad = 0;
    c->err = 0;
    while (i < end) {
        uint8_t b = data[i++];
        uint8_t d = (uint8_t)(b - '0');
        if (d <= 9) {
            value = value * 10u + d;
            if (value > 65535u) { bad = 1; value = 70000u; }
            len++;
            continue;
        }
        if (b == '#') {
            while (i < end && data[i] != '\n') i++;
            if (i < end) i++;
            continue;
        }
        if (is_ws(b)) {
            if (len) {
                if (bad) { c->err = -2; return NULL; }
                if (value > maxval) { c->err = -4; return NULL; }
                if (c->elem_size == 1) o8[idx] = (uint8_t)value;
                else o16[idx] = (uint16_t)value;
                idx++;
                value = 0; len = 0;
            }
            continue;
        }
        bad = 1; len++;   /* non-digit token byte */
    }
    if (len) {            /* trailing token at true end of input */
        if (bad) { c->err = -2; return NULL; }
        if (value > maxval) { c->err = -4; return NULL; }
        if (c->elem_size == 1) o8[idx] = (uint8_t)value;
        else o16[idx] = (uint16_t)value;
        idx++;
    }
    c->count = idx - c->out_off;
    return NULL;
}

/* Serial comment-aware token scan: read one token starting at *pos.
 * Returns token length (0 at end of input), token bytes in tok (cap 16,
 * longer tokens flagged bad via *bad), numeric value in *value. */
static int ppm_next_token(const uint8_t *data, long n, long *pos,
                          uint32_t *value, int *bad, uint8_t *t0, uint8_t *t1) {
    long i = *pos;
    int in_comment = 0, len = 0;
    uint32_t v = 0;
    int b_ = 0;
    while (i < n) {
        uint8_t b = data[i++];
        if (in_comment) { if (b == '\n') in_comment = 0; continue; }
        if (b == '#') { in_comment = 1; continue; }
        if (is_ws(b)) {
            if (len) break;
            continue;
        }
        if (len == 0) *t0 = b; else if (len == 1) *t1 = b;
        if (b >= '0' && b <= '9') {
            v = v * 10u + (uint32_t)(b - '0');
            if (v > 65535u) b_ = 1;
        } else b_ = 1;
        len++;
    }
    *pos = i; *value = v; *bad = b_;
    return len;
}

long dmmt_parse_ppm_mt(const uint8_t *data, long n, uint32_t *hdr,
                       void *out, long cap, int elem_size, int nthreads) {
    long pos = 0;
    uint32_t value; int bad; uint8_t t0 = 0, t1 = 0;

    /* magic */
    int len = ppm_next_token(data, n, &pos, &value, &bad, &t0, &t1);
    if (len != 2 || t0 != 'P' || t1 != '3') return -3;
    /* width, height, maxval */
    for (int k = 0; k < 3; k++) {
        len = ppm_next_token(data, n, &pos, &value, &bad, &t0, &t1);
        if (len == 0) return -5;
        if (bad) return -2;
        hdr[k] = value;
    }
    uint32_t maxval = hdr[2];
    if (elem_size == 1 && maxval > 255u) return -2;

    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if (n - pos < (1L << 20)) nthreads = 1;

    /* chunk boundaries: whitespace outside comments. If the input has no
     * '#' at all, any whitespace splits safely. */
    const uint8_t *first_hash = memchr(data + pos, '#', (size_t)(n - pos));
    long bounds[17];
    bounds[0] = pos;
    bounds[nthreads] = n;
    for (int t = 1; t < nthreads; t++) {
        long p = pos + (n - pos) * t / nthreads;
        if (p < bounds[t - 1]) p = bounds[t - 1];
        if (first_hash == NULL) {
            while (p < n && !is_ws(data[p])) p++;
        } else {
            /* leave any comment: advance past the next newline, then track
             * comment state to the next whitespace */
            while (p < n && data[p] != '\n') p++;
            if (p < n) p++;
            int in_comment = 0;
            while (p < n) {
                uint8_t b = data[p];
                if (in_comment) { if (b == '\n') in_comment = 0; }
                else if (b == '#') in_comment = 1;
                else if (is_ws(b)) break;
                p++;
            }
        }
        bounds[t] = p;
    }

    /* worst-case-spaced regions in the reusable scratch: a chunk of B
     * bytes yields at most B/2 + 1 values */
    pthread_mutex_lock(&ppm_scratch_lock);
    size_t need = ((size_t)(n - pos) / 2 + 17) * (size_t)elem_size;
    if (ppm_scratch_size < need) {
        free(ppm_scratch);
        ppm_scratch = malloc(need);
        ppm_scratch_size = ppm_scratch ? need : 0;
        if (!ppm_scratch) { pthread_mutex_unlock(&ppm_scratch_lock); return -6; }
    }
    void *scratch = ppm_scratch;

    ppm_chunk_t chunks[16];
    pthread_t tids[16];
    long roff = 0;
    for (int t = 0; t < nthreads; t++) {
        long b = bounds[t + 1] - bounds[t];
        chunks[t].data = data;
        chunks[t].begin = bounds[t];
        chunks[t].end = bounds[t + 1];
        chunks[t].out = scratch;
        chunks[t].out_off = roff;
        chunks[t].cap = cap;
        chunks[t].elem_size = elem_size;
        chunks[t].maxval = maxval;
        chunks[t].count = 0;
        chunks[t].err = 0;
        roff += b / 2 + 1;
    }

    int spawn_err = 0;
    for (int t = 1; t < nthreads; t++)
        if (pthread_create(&tids[t], NULL, ppm_parse_worker, &chunks[t])) {
            spawn_err = 1; nthreads = t; break;
        }
    ppm_parse_worker(&chunks[0]);
    for (int t = 1; t < nthreads; t++) pthread_join(tids[t], NULL);
    if (spawn_err) { pthread_mutex_unlock(&ppm_scratch_lock); return -6; }

    long err = 0, total = 0;
    for (int t = 0; t < nthreads; t++) {
        if (chunks[t].err && !err) err = chunks[t].err;
        total += chunks[t].count;
    }
    if (!err && total > cap) err = -1;
    if (err) { pthread_mutex_unlock(&ppm_scratch_lock); return err; }

    /* compact the spaced regions into the caller's exact-size buffer */
    long off = 0;
    for (int t = 0; t < nthreads; t++) {
        long cnt = chunks[t].count;
        if (cnt)
            memcpy((uint8_t *)out + (size_t)off * elem_size,
                   (uint8_t *)scratch + (size_t)chunks[t].out_off * elem_size,
                   (size_t)cnt * elem_size);
        off += cnt;
    }
    pthread_mutex_unlock(&ppm_scratch_lock);
    return total;
}
