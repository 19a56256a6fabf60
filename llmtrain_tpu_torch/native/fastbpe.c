/* Native BPE word encoder — the hot inner loop of data/bpe.py.
 *
 * The Python tokenizer keeps a per-word memo, so this accelerates COLD
 * words: high-entropy corpora (source code, many unique identifiers)
 * spend their tokenize time in the greedy lowest-rank merge loop. The
 * algorithm here is bit-identical to BPETokenizer._encode_word: repeat
 * { find the adjacent pair with the lowest merge rank; fuse it } until
 * no adjacent pair has a rank.
 *
 * Built on demand by llmtrain_tpu_torch/native/__init__.py (cc -O2
 * -shared) into build/native/ at the checkout root, loaded via ctypes;
 * everything degrades to the pure-Python path when no compiler is
 * available. A host tokenizer helper, not a device kernel.
 *
 * Pair lookup: open-addressed hash table keyed on (a << 32) | b with
 * linear probing; sized to >= 2x the merge count rounded up to a power
 * of two, so probes are short and the table fits caches for real
 * vocabularies (tens of thousands of merges).
 */

#include <limits.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    uint64_t *keys;   /* (a << 32) | b, EMPTY when unused */
    int32_t *ranks;
    uint64_t mask;    /* table_size - 1 */
    int32_t n_merges;
} FastBpe;

static const uint64_t EMPTY = ~(uint64_t)0;

static uint64_t hash_key(uint64_t k) {
    /* splitmix64 finalizer — well-distributed for sequential ids. */
    k ^= k >> 30; k *= 0xbf58476d1ce4e5b9ULL;
    k ^= k >> 27; k *= 0x94d049bb133111ebULL;
    k ^= k >> 31;
    return k;
}

FastBpe *fastbpe_new(const int32_t *merges, int32_t n_merges) {
    uint64_t size = 16;
    while (size < (uint64_t)n_merges * 2) size <<= 1;
    FastBpe *ctx = (FastBpe *)malloc(sizeof(FastBpe));
    if (!ctx) return NULL;
    ctx->keys = (uint64_t *)malloc(size * sizeof(uint64_t));
    ctx->ranks = (int32_t *)malloc(size * sizeof(int32_t));
    if (!ctx->keys || !ctx->ranks) {
        free(ctx->keys); free(ctx->ranks); free(ctx);
        return NULL;
    }
    for (uint64_t i = 0; i < size; i++) ctx->keys[i] = EMPTY;
    ctx->mask = size - 1;
    ctx->n_merges = n_merges;
    for (int32_t r = 0; r < n_merges; r++) {
        uint64_t key = ((uint64_t)(uint32_t)merges[2 * r] << 32)
                     | (uint32_t)merges[2 * r + 1];
        uint64_t i = hash_key(key) & ctx->mask;
        while (ctx->keys[i] != EMPTY) i = (i + 1) & ctx->mask;
        ctx->keys[i] = key;
        ctx->ranks[i] = r;
    }
    return ctx;
}

void fastbpe_free(FastBpe *ctx) {
    if (!ctx) return;
    free(ctx->keys);
    free(ctx->ranks);
    free(ctx);
}

static int32_t lookup(const FastBpe *ctx, int32_t a, int32_t b) {
    uint64_t key = ((uint64_t)(uint32_t)a << 32) | (uint32_t)b;
    uint64_t i = hash_key(key) & ctx->mask;
    while (ctx->keys[i] != EMPTY) {
        if (ctx->keys[i] == key) return ctx->ranks[i];
        i = (i + 1) & ctx->mask;
    }
    return -1;
}

/* Encode one pre-tokenized word (UTF-8 bytes). out must hold n ints.
 * Returns the token count (<= n); n == 0 returns 0. */
int32_t fastbpe_encode_word(
    const FastBpe *ctx, const uint8_t *bytes, int32_t n, int32_t *out
) {
    int32_t len = n;
    for (int32_t i = 0; i < n; i++) out[i] = bytes[i];
    while (len >= 2) {
        int32_t best_rank = INT32_MAX, best_i = -1;
        for (int32_t i = 0; i + 1 < len; i++) {
            int32_t r = lookup(ctx, out[i], out[i + 1]);
            if (r >= 0 && r < best_rank) { best_rank = r; best_i = i; }
        }
        if (best_i < 0) break;
        /* Fuse EVERY occurrence of the winning pair left to right,
         * skipping overlaps — mirrors bpe.py's _merge. */
        int32_t a = out[best_i], b = out[best_i + 1];
        int32_t merged = 256 + best_rank;
        int32_t w = 0;
        for (int32_t i = 0; i < len; ) {
            if (i + 1 < len && out[i] == a && out[i + 1] == b) {
                out[w++] = merged;
                i += 2;
            } else {
                out[w++] = out[i++];
            }
        }
        len = w;
    }
    return len;
}
