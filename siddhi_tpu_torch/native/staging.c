/* Host-side staging kernels for the TPU streaming runtime.
 *
 * Reference role (what): the per-event hot path the JVM engine runs in
 * CORE/query/selector/GroupByKeyGenerator.java:63 (string-concat group keys),
 * CORE/util/snapshot/state/PartitionStateHolder.java:43 (keyed state maps)
 * and CORE/partition/PartitionStreamReceiver.java:100-216 (clone-per-key
 * chunk grouping).
 *
 * TPU design (how): the host must turn a raw event micro-batch into the
 * device's dense [K, E] key layout faster than the chip consumes it.  numpy
 * needed ~75ms per 524k-event batch (hash temporaries + argsort); this C
 * path is a fused single pass: FNV-style 128-bit key hashing, open-address
 * probe/insert into an INTERLEAVED cell table (h1,h2,slot in one 24-byte
 * cell, so a probe costs one cache line, not three), and counting-sort
 * grouping whose count pass is fused into the probe loop.  The column
 * gather itself happens ON DEVICE (a [K,E] gather is ~60us on TPU), so the
 * host never copies event payloads at all.
 *
 * Single-threaded by design: the host it was tuned on has one core; the win is
 * constant-factor (cache lines, fused passes), not parallelism.
 */
#include <stdint.h>
#include <string.h>
#include <stdlib.h>

#define FNV_OFF 0xCBF29CE484222325ULL
#define FNV_PRIME 0x100000001B3ULL
#define MIX 0x9E3779B97F4A7C15ULL
#define EMPTY 0ULL
#define TOMB 1ULL

/* cells: [cap2][3] u64 = {h1, h2, slot}; h1 0=empty 1=tombstone. */
#define C_H1(c, i) ((c)[(i) * 3])
#define C_H2(c, i) ((c)[(i) * 3 + 1])
#define C_SLOT(c, i) ((int32_t)(c)[(i) * 3 + 2])

/* Must match keyslots._hash_words exactly (snapshot compatibility: Python
 * rebuild/restore re-hashes with its own implementation). */
static inline uint64_t hash_words(const uint64_t *w, int64_t w8,
                                  uint64_t seed) {
    uint64_t h = FNV_OFF ^ seed;
    for (int64_t j = 0; j < w8; j++) {
        h = (h ^ w[j]) * FNV_PRIME;
        h = (h ^ (h >> 29)) * MIX;
    }
    h ^= h >> 32;
    return h;
}

/* meta: [0]=count [1]=free_top [2]=tombstones [3]=journal_len
 *       [4]=journal_overflow [5]=journal_cap
 * free_stack[free_top-1] is the next slot to pop.
 *
 * Optionally fuses the grouping count pass: when cnt/touched/group_meta are
 * non-NULL, per-slot occurrence counts accumulate during the probe loop
 * (group_meta: [0]=n_uniq out, [1]=max_count out).
 *
 * Returns number of newly inserted keys, or -1 on capacity exhaustion. */
int64_t sg_slots_for(const uint64_t *words, int64_t n, int64_t w8,
                     const uint8_t *live,
                     uint64_t *cells, int64_t cap2,
                     int64_t *cell_by_slot, uint8_t *arena,
                     int32_t *free_stack, int32_t *journal, uint8_t *used,
                     int64_t *meta, int32_t lookup_only,
                     int32_t *out_slots,
                     int32_t *cnt, int32_t *touched, int64_t *group_meta,
                     uint64_t *pcache, int64_t pc_mask) {
    const uint64_t mask = (uint64_t)(cap2 - 1);
    const int64_t wb = w8 * 8;
    int64_t inserted = 0;
    int64_t n_uniq = 0;
    int32_t maxc = 0;
    /* The cell table is far larger than L2, so nearly every probe is a
     * cache miss; hash the lookahead key and prefetch its home cell a few
     * iterations early to overlap the misses. */
    enum { LOOKAHEAD = 12 };
    for (int64_t i = 0; i < n; i++) {
        if (i + LOOKAHEAD < n && (!live || live[i + LOOKAHEAD])) {
            uint64_t ph = hash_words(words + (i + LOOKAHEAD) * w8, w8, 0);
            __builtin_prefetch(&cells[(ph & mask) * 3], 0, 1);
        }
        if (live && !live[i]) { out_slots[i] = -1; continue; }
        const uint64_t *key = words + i * w8;
        uint64_t h1 = hash_words(key, w8, 0);
        if (h1 < 2) h1 = 2;
        uint64_t h2 = hash_words(key, w8, 0xABCD);
        int32_t slot = -1;
        /* L2-resident direct-mapped cache in front of the big table:
         * events of one key cluster within a batch, so most probes hit
         * here instead of missing into the (HBM-sized) cell table.
         * Invalidated wholesale by Python on purge/rebuild/restore. */
        uint64_t pidx = (h1 & (uint64_t)pc_mask) * 3;
        if (pcache[pidx] == h1 && pcache[pidx + 1] == h2) {
            slot = (int32_t)pcache[pidx + 2];
        } else {
            /* bounded: cap2 steps visit every cell, so exceeding the bound
             * (possible when purge-churn tombstones consume the last EMPTY
             * cells) proves absence instead of spinning forever. */
            uint64_t idx = h1 & mask;
            for (int64_t probes = 0; probes < cap2; probes++) {
                uint64_t c = C_H1(cells, idx);
                if (c == h1 && C_H2(cells, idx) == h2) {
                    slot = C_SLOT(cells, idx); break;
                }
                if (c == EMPTY) break;
                idx = (idx + 1) & mask;
            }
            if (slot >= 0) {
                pcache[pidx] = h1; pcache[pidx + 1] = h2;
                pcache[pidx + 2] = (uint64_t)(uint32_t)slot;
            }
        }
        if (slot < 0 && !lookup_only) {
            if (meta[1] <= 0) return -1;          /* capacity exhausted */
            slot = free_stack[--meta[1]];
            /* insert at first EMPTY or TOMB cell */
            uint64_t j = h1 & mask;
            while (C_H1(cells, j) > TOMB) j = (j + 1) & mask;
            C_H1(cells, j) = h1; C_H2(cells, j) = h2;
            cells[j * 3 + 2] = (uint64_t)(uint32_t)slot;
            cell_by_slot[slot] = (int64_t)j;
            memcpy(arena + (int64_t)slot * wb, key, (size_t)wb);
            used[slot] = 1;
            meta[0]++;
            if (meta[3] < meta[5]) journal[meta[3]++] = slot;
            else meta[4] = 1;                     /* journal overflow */
            inserted++;
            pcache[pidx] = h1; pcache[pidx + 1] = h2;
            pcache[pidx + 2] = (uint64_t)(uint32_t)slot;
        }
        out_slots[i] = slot;
        if (cnt && slot >= 0) {                   /* fused group count */
            int32_t c2 = ++cnt[slot];
            if (c2 == 1) touched[n_uniq++] = slot;
            if (c2 > maxc) maxc = c2;
        }
    }
    if (group_meta) { group_meta[0] = n_uniq; group_meta[1] = maxc; }
    return inserted;
}

/* Rebuild the probe table from the arena (tombstone GC / restore). */
void sg_rebuild(uint64_t *cells, int64_t cap2,
                int64_t *cell_by_slot, const uint8_t *arena, int64_t w8,
                const uint8_t *used, int64_t capacity) {
    const uint64_t mask = (uint64_t)(cap2 - 1);
    memset(cells, 0, (size_t)cap2 * 24);
    for (int64_t s = 0; s < capacity; s++) {
        cell_by_slot[s] = -1;
        if (!used[s]) continue;
        const uint64_t *key = (const uint64_t *)(arena + s * w8 * 8);
        uint64_t h1 = hash_words(key, w8, 0);
        if (h1 < 2) h1 = 2;
        uint64_t h2 = hash_words(key, w8, 0xABCD);
        uint64_t j = h1 & mask;
        while (C_H1(cells, j) > TOMB) j = (j + 1) & mask;
        C_H1(cells, j) = h1; C_H2(cells, j) = h2;
        cells[j * 3 + 2] = (uint64_t)(uint32_t)s;
        cell_by_slot[s] = (int64_t)j;
    }
}

/* Standalone count pass (used when slots come from elsewhere, e.g. the
 * sharded path regrouping by local slot). */
int64_t sg_group_count(const int32_t *slots, const uint8_t *valid, int64_t n,
                       int32_t *cnt, int32_t *touched,
                       int64_t *max_count_out) {
    int64_t u = 0;
    int32_t maxc = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t s = slots[i];
        if (s < 0 || (valid && !valid[i])) continue;
        int32_t c = ++cnt[s];
        if (c == 1) touched[u++] = s;
        if (c > maxc) maxc = c;
    }
    *max_count_out = maxc;
    return u;
}

static void radix_sort_u32(uint32_t *a, int64_t n, uint32_t *tmp) {
    int64_t hist[2048];
    for (int shift = 0; shift < 32; shift += 11) {
        memset(hist, 0, sizeof(hist));
        const uint32_t m = (shift + 11 >= 32) ? (0xFFFFFFFFu >> shift)
                                              : 0x7FFu;
        for (int64_t i = 0; i < n; i++)
            hist[(a[i] >> shift) & m]++;
        int64_t sum = 0;
        for (int64_t b = 0; b < 2048; b++) {
            int64_t c = hist[b]; hist[b] = sum; sum += c;
        }
        for (int64_t i = 0; i < n; i++)
            tmp[hist[(a[i] >> shift) & m]++] = a[i];
        memcpy(a, tmp, (size_t)n * 4);
    }
}

/* Fill pass: sort unique slots ascending, emit key_idx [Kb] (pad beyond
 * n_uniq), sel [Kb*E] (-1 = padding), re-zero cnt.  rank is a scratch
 * array >= capacity.  Returns 1 if slots are one contiguous ascending run
 * starting at key_idx[0] (dense fast path), else 0. */
int32_t sg_group_fill(const int32_t *slots, const uint8_t *valid, int64_t n,
                      int32_t *cnt, int32_t *rank, int32_t *touched,
                      int64_t n_uniq, int64_t Kb, int64_t E, int32_t pad,
                      int32_t *key_idx, int32_t *sel) {
    uint32_t *tmp = (uint32_t *)malloc((size_t)n_uniq * 4);
    radix_sort_u32((uint32_t *)touched, n_uniq, tmp);
    free(tmp);
    for (int64_t k = 0; k < Kb; k++)
        key_idx[k] = (k < n_uniq) ? touched[k] : pad;
    memset(sel, 0xFF, (size_t)(Kb * E) * 4);
    for (int64_t k = 0; k < n_uniq; k++) {
        rank[touched[k]] = (int32_t)k;
        cnt[touched[k]] = 0;                      /* reuse as within-counter */
    }
    for (int64_t i = 0; i < n; i++) {
        int32_t s = slots[i];
        if (s < 0 || (valid && !valid[i])) continue;
        int64_t r = rank[s];
        sel[r * E + cnt[s]++] = (int32_t)i;
    }
    for (int64_t k = 0; k < n_uniq; k++)
        cnt[touched[k]] = 0;                      /* leave cnt clean */
    return (n_uniq > 0 &&
            touched[n_uniq - 1] == touched[0] + (int32_t)(n_uniq - 1)) ? 1 : 0;
}

/* Key hotness feed (port of siddhi_tpu/observability/stateobs.py
 * KeyHotness.update): one staged batch's key set (slot ids + per-key row
 * counts) folds into a count-min sketch (4 rows x 1024 int64 counters), an
 * exact distinct bitmap and a space-saving top-64.  The results equal the
 * JAX package's numpy / dict version exactly:
 *   - a row's counter is ((k + 1) * mult) % 2^31 % 1024 in numpy's int64
 *     arithmetic (wrapping product, floor modulo);
 *   - keys < 0 or counts <= 0 are skipped;
 *   - the top-64 keeps the dict's insertion order: a tracked key adds in
 *     place, a new key appends while there is room, else it replaces the
 *     victim `min(ss, key=ss.get)` (the FIRST entry, in insertion order,
 *     with the least count) and takes its count plus its own, moving to
 *     the end of the order (the dict's pop then insert).
 * The entries sit in fixed slots (keys, counts) linked in insertion order
 * (nxt / prv, aux HEAD / TAIL), so a replacement relinks instead of
 * shifting.  Two caches keep a key's work O(1) in the common case, both
 * rebuilt from the entries whenever aux[AUX_VALID] is 0 (a fresh tracker,
 * or entries the caller rewrote):
 *   - a counting filter over (k & 4095) of the tracked keys: a key whose
 *     bucket is empty is untracked without scanning the entries;
 *   - the least count MIN and a CURSOR slot: every entry before the
 *     cursor in the order holds more than MIN, so the victim is the first
 *     entry from the cursor on whose count is MIN; after a replacement the
 *     next victim can only come after the victim's place, and a walk that
 *     finds none means the least count rose: rescan from the head.
 * Returns the rows added to the total. */
#define HOT_DEPTH 4
#define HOT_WIDTH 1024
#define HOT_TOPK 64
#define HOT_FILTER 4096
enum { AUX_VALID, AUX_MIN, AUX_CURSOR, AUX_HEAD, AUX_TAIL, AUX_LEN };

static const int64_t HOT_MULT[HOT_DEPTH] = {0x9E3779B1LL, 0x85EBCA77LL,
                                            0xC2B2AE35LL, 0x27D4EB2FLL};

static inline int64_t hot_bucket(int64_t k, int64_t mult) {
  int64_t p = (int64_t)((uint64_t)(k + 1) * (uint64_t)mult);
  int64_t r = p % 2147483648LL;
  if (r < 0) r += 2147483648LL;
  return r % HOT_WIDTH;
}

/* MIN over the entries and CURSOR at the first slot holding it. */
static void hot_rescan(const int64_t *counts, const int32_t *nxt,
                       int64_t *aux) {
  int64_t mn = INT64_MAX;
  int64_t at = -1;
  for (int64_t j = aux[AUX_HEAD]; j >= 0; j = nxt[j])
    if (counts[j] < mn) { mn = counts[j]; at = j; }
  aux[AUX_MIN] = mn;
  aux[AUX_CURSOR] = at;
}

int64_t sg_hot_update(int64_t *cms, uint8_t *seen, int64_t cap,
                      int64_t *ss_keys, int64_t *ss_counts, int32_t *ss_n,
                      int32_t *nxt, int32_t *prv, int64_t *aux,
                      uint16_t *filter, const int64_t *keys,
                      const int64_t *counts, int64_t n) {
  int64_t added = 0;
  int32_t m = *ss_n;
  if (!aux[AUX_VALID]) {
    memset(filter, 0, HOT_FILTER * sizeof(uint16_t));
    for (int32_t j = 0; j < m; ++j) ++filter[ss_keys[j] & (HOT_FILTER - 1)];
    hot_rescan(ss_counts, nxt, aux);
    aux[AUX_VALID] = 1;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = keys[i], c = counts[i];
    if (k < 0 || c <= 0) continue;
    added += c;
    if (k < cap) seen[k] = 1;
    for (int d = 0; d < HOT_DEPTH; ++d)
      cms[d * HOT_WIDTH + hot_bucket(k, HOT_MULT[d])] += c;
    const int64_t fb = k & (HOT_FILTER - 1);
    int32_t at = -1;
    if (filter[fb])
      for (int32_t j = 0; j < m; ++j)
        if (ss_keys[j] == k) { at = j; break; }
    if (at >= 0) {
      ss_counts[at] += c;   /* the cursor stays a lower bound */
      continue;
    }
    int32_t v;
    int64_t base = 0;
    if (m < HOT_TOPK) {
      v = m++;
    } else {
      v = -1;
      for (int64_t j = aux[AUX_CURSOR]; j >= 0; j = nxt[j])
        if (ss_counts[j] == aux[AUX_MIN]) { v = (int32_t)j; break; }
      if (v < 0) {          /* the least count rose: rescan */
        hot_rescan(ss_counts, nxt, aux);
        v = (int32_t)aux[AUX_CURSOR];
      }
      base = ss_counts[v];
      --filter[ss_keys[v] & (HOT_FILTER - 1)];
      /* unlink v; the next victim comes after its place */
      const int32_t a = prv[v], b = nxt[v];
      if (a >= 0) nxt[a] = b; else aux[AUX_HEAD] = b;
      if (b >= 0) prv[b] = a; else aux[AUX_TAIL] = a;
      aux[AUX_CURSOR] = b >= 0 ? b : aux[AUX_HEAD];
    }
    ss_keys[v] = k;
    ss_counts[v] = base + c;
    ++filter[fb];
    /* link v at the tail */
    prv[v] = (int32_t)aux[AUX_TAIL];
    nxt[v] = -1;
    if (aux[AUX_TAIL] >= 0) nxt[aux[AUX_TAIL]] = v; else aux[AUX_HEAD] = v;
    aux[AUX_TAIL] = v;
    if (base == 0 && ss_counts[v] < aux[AUX_MIN]) {
      /* an append below the least count: it is the new minimum, and no
       * entry before it holds that little */
      aux[AUX_MIN] = ss_counts[v];
      aux[AUX_CURSOR] = v;
    } else if (base == 0 && aux[AUX_CURSOR] < 0) {
      aux[AUX_CURSOR] = v;
    }
  }
  *ss_n = m;
  return added;
}

/* Per-key row counts of a [K, E] group selection (entries < 0 are
 * padding): the hotness feed's counts for a grouped batch. */
void sg_row_counts(const int32_t *sel, int64_t K, int64_t E, int64_t *out) {
  for (int64_t k = 0; k < K; ++k) {
    const int32_t *row = sel + k * E;
    int64_t c = 0;
    for (int64_t e = 0; e < E; ++e) c += row[e] >= 0;
    out[k] = c;
  }
}
