// Native host tier of flowgger_tpu_torch: the host-side hot loops of the
// batched pipeline's encode stages, a trimmed copy of the JAX package's
// native/flowgger_host.cpp (999 lines), built with g++ at first use by
// flowgger_tpu_torch/native.py and bound through ctypes.
//
// Copied from native/flowgger_host.cpp, algorithms unchanged:
//   the GELF row engine :357-716 (escape tables and helpers :381-476,
//   the pair sort with kMaxPairs :478-520, the syslen prefix :522-540,
//   gelf_row_len :558, gelf_row_write :608, run_threaded :664,
//   fg_gelf_lens_v2 :687, fg_gelf_write_v2 :701);
//   fg_r5_lens / fg_r5_write :718-885 (the RFC5424 output's row writer,
//   r5_row_len :754, r5_row_write :784);
//   fg_concat_segments :887-904;
//   json_f64_render :908-970 and fg_format_f64_json :976-997;
//   fg_crc32c :122-166 and the snappy codec fg_snappy_max_compressed /
//   fg_snappy_compress / fg_snappy_decompress :168-355 (the Kafka
//   sink's record batches v2), at the end of this file.
// Left out: fg_split_lines, fg_split_syslen and fg_pack_lines :26-120
// (the port frames on the card; its host framing serves only declines
// and the end-of-stream record, on numpy and Python).  The extern "C"
// blocks are regrouped so that none holds a namespace.
//
// Outputs are contracts held by tests/test_torch_native.py against the
// numpy and Python versions beside the callers and against the JAX
// package's library: row bytes and lengths, the gathered bytes and the
// f64 text.  tests/native_host/test_host.cpp runs it under ASan and
// UBSan.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <functional>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Columnar RFC5424 -> GELF row assembly (the encode hot loop of
// gelf_encoder.rs:51-116, batched): given the decode kernel's span
// tables, emit each row's GELF JSON bytes directly from the chunk.
// Two phases — fg_gelf_lens_v2 measures exact output lengths, the
// caller prefix-sums them, fg_gelf_write_v2 fills the buffer in
// parallel.  (v2: the escaped-SD-value flags changed the signature; the
// suffix keeps a stale prebuilt .so from being called with a shifted
// argument layout — loaders feature-test the symbol name.)
// JSON escaping matches json.encoder.encode_basestring (backslash,
// quote, \b \t \n \f \r shortcuts, \u00XX for other control bytes);
// differential tests in tests/test_torch_native.py pin the bytes
// against the scalar encoder.
// ---------------------------------------------------------------------------

namespace {

// rowmeta columns (int32, row-major [R, 17]); span offsets row-relative
enum {
    M_START = 0, M_HOST_S, M_HOST_E, M_APP_S, M_APP_E, M_PROC_S, M_PROC_E,
    M_MSG_A, M_TRIM_E, M_FULL_S, M_SEV, M_NSD, M_SID_S, M_SID_E,
    M_TS_OFF, M_TS_LEN, M_NPAIR, M_NCOL
};

struct EscTables {
    uint8_t width[256];
    char seq[256][8];
    EscTables() {
        for (int b = 0; b < 256; b++) {
            width[b] = 1;
            seq[b][0] = (char)b;
        }
        auto two = [&](int b, char c) {
            width[b] = 2; seq[b][0] = '\\'; seq[b][1] = c;
        };
        for (int b = 0; b < 0x20; b++) {
            width[b] = 6;
            snprintf(seq[b], 8, "\\u%04x", b);
        }
        two('\b', 'b'); two('\t', 't'); two('\n', 'n');
        two('\f', 'f'); two('\r', 'r'); two('"', '"'); two('\\', '\\');
    }
};
const EscTables kEsc;

inline int64_t esc_len(const uint8_t* s, int64_t len) {
    int64_t out = 0;
    for (int64_t i = 0; i < len; i++) out += kEsc.width[s[i]];
    return out;
}

inline uint8_t* esc_write(uint8_t* dst, const uint8_t* s, int64_t len) {
    for (int64_t i = 0; i < len; i++) {
        uint8_t w = kEsc.width[s[i]];
        if (w == 1) {
            *dst++ = s[i];
        } else {
            memcpy(dst, kEsc.seq[s[i]], w);
            dst += w;
        }
    }
    return dst;
}

// SD-escaped values: RFC5424 unescape (backslash before '"' '\\' ']'
// collapses; any other backslash is literal — rfc5424_decoder.rs:105-125
// semantics) composed with the JSON escape, in one walk.
inline int64_t esc_len_sd(const uint8_t* s, int64_t len) {
    int64_t out = 0;
    int64_t i = 0;
    while (i < len) {
        uint8_t b = s[i];
        if (b == '\\' && i + 1 < len) {
            uint8_t c = s[i + 1];
            if (c == '"' || c == '\\' || c == ']')
                out += kEsc.width[c];
            else
                out += kEsc.width[(uint8_t)'\\'] + kEsc.width[c];
            i += 2;
        } else {
            out += kEsc.width[b];
            i += 1;
        }
    }
    return out;
}

inline uint8_t* esc_write_sd(uint8_t* dst, const uint8_t* s, int64_t len) {
    auto put1 = [&](uint8_t b) {
        uint8_t w = kEsc.width[b];
        if (w == 1) {
            *dst++ = b;
        } else {
            memcpy(dst, kEsc.seq[b], w);
            dst += w;
        }
    };
    int64_t i = 0;
    while (i < len) {
        uint8_t b = s[i];
        if (b == '\\' && i + 1 < len) {
            uint8_t c = s[i + 1];
            if (!(c == '"' || c == '\\' || c == ']'))
                put1('\\');
            put1(c);
            i += 2;
        } else {
            put1(b);
            i += 1;
        }
    }
    return dst;
}

inline uint8_t* put(uint8_t* dst, const char* s, size_t len) {
    memcpy(dst, s, len);
    return dst + len;
}

#define LIT(dst, s) put(dst, s, sizeof(s) - 1)

const int kMaxPairs = 64;

// sorted pair order with exact dict semantics: stable sort by name
// bytes, then among equal names only the last (original order) survives
// (Python dict last-wins + sorted(keys)).  Returns count of emitted
// pairs; idx_out holds their original indices in emit order.
inline int sort_pairs(const uint8_t* chunk, int64_t base,
                      const int32_t* ns, const int32_t* ne, int p,
                      int* idx_out) {
    int idx[kMaxPairs];
    for (int i = 0; i < p; i++) idx[i] = i;
    // insertion sort (p is small), stable
    for (int i = 1; i < p; i++) {
        int cur = idx[i];
        const uint8_t* cs = chunk + base + ns[cur];
        int cl = ne[cur] - ns[cur];
        int j = i - 1;
        while (j >= 0) {
            const uint8_t* js = chunk + base + ns[idx[j]];
            int jl = ne[idx[j]] - ns[idx[j]];
            int c = memcmp(js, cs, (size_t)std::min(jl, cl));
            if (c < 0 || (c == 0 && jl <= cl)) break;
            idx[j + 1] = idx[j];
            j--;
        }
        idx[j + 1] = cur;
    }
    int out = 0;
    for (int i = 0; i < p; i++) {
        if (i + 1 < p) {  // name equal to the next entry? skip — the
            // sort is stable, so the run's last element carries the
            // last original occurrence (dict last-wins)
            int a = idx[i], b = idx[i + 1];
            int al = ne[a] - ns[a], bl = ne[b] - ns[b];
            if (al == bl &&
                memcmp(chunk + base + ns[a], chunk + base + ns[b],
                       (size_t)al) == 0)
                continue;
        }
        idx_out[out++] = idx[i];
    }
    return out;
}

inline int dec_digits(int64_t v) {
    int d = 1;
    while (v >= 10) { v /= 10; d++; }
    return d;
}

// syslen framing prefix "{body} ": the caller only knows the total
// framed length, so recover body = framed - digits(body) - 1 by
// scanning digit counts (unique fixpoint, dec_digits is monotonic)
inline uint8_t* put_syslen_prefix(uint8_t* dst, int64_t framed_len) {
    int64_t body = framed_len;
    for (int d = 1; d <= 10; d++) {
        int64_t cand = framed_len - d - 1;
        if (dec_digits(cand) == d) { body = cand; break; }
    }
    char buf[16];
    int nb = snprintf(buf, sizeof buf, "%lld ", (long long)body);
    return put(dst, buf, (size_t)nb);
}

struct GelfArgs {
    const uint8_t* chunk;
    const int32_t* meta;      // [R, M_NCOL]
    int64_t R;
    const int32_t* pns;       // [R, P] name/val spans, row-relative
    const int32_t* pne;
    const int32_t* pvs;
    const int32_t* pve;
    const int32_t* pesc;      // [R, P] value-needs-SD-unescape flags
    int32_t P;
    const uint8_t* ts_scratch;
    const uint8_t* suffix;
    int32_t suffix_len;
    int32_t syslen;
};

int64_t gelf_row_len(const GelfArgs& a, int64_t r) {
    const int32_t* m = a.meta + r * M_NCOL;
    const uint8_t* chunk = a.chunk;
    int64_t base = m[M_START];
    int64_t len = 0;
    int p = m[M_NPAIR];
    if (p > 0) {
        const int32_t* ns = a.pns + r * a.P;
        const int32_t* ne = a.pne + r * a.P;
        const int32_t* vs = a.pvs + r * a.P;
        const int32_t* ve = a.pve + r * a.P;
        const int32_t* pe = a.pesc + r * a.P;
        int order[kMaxPairs];
        int cnt = sort_pairs(chunk, base, ns, ne, p, order);
        for (int k = 0; k < cnt; k++) {
            int i = order[k];
            len += 2 + 3 + 2;  // "_  ":"  ",
            len += esc_len(chunk + base + ns[i], ne[i] - ns[i]);
            len += pe[i]
                ? esc_len_sd(chunk + base + vs[i], ve[i] - vs[i])
                : esc_len(chunk + base + vs[i], ve[i] - vs[i]);
        }
    }
    len += 1;                                   // {
    len += sizeof("\"application_name\":\"") - 1;
    len += esc_len(chunk + base + m[M_APP_S], m[M_APP_E] - m[M_APP_S]);
    len += sizeof("\",\"full_message\":\"") - 1;
    len += esc_len(chunk + base + m[M_FULL_S], m[M_TRIM_E] - m[M_FULL_S]);
    len += sizeof("\",\"host\":\"") - 1;
    int64_t hl = m[M_HOST_E] - m[M_HOST_S];
    len += hl ? esc_len(chunk + base + m[M_HOST_S], hl)
              : (int64_t)(sizeof("unknown") - 1);
    len += sizeof("\",\"level\":") - 1 + 1;     // single severity digit
    len += sizeof(",\"process_id\":\"") - 1;
    len += esc_len(chunk + base + m[M_PROC_S], m[M_PROC_E] - m[M_PROC_S]);
    if (m[M_NSD]) {
        len += sizeof("\",\"sd_id\":\"") - 1;
        len += esc_len(chunk + base + m[M_SID_S], m[M_SID_E] - m[M_SID_S]);
    }
    len += sizeof("\",\"short_message\":\"") - 1;
    int64_t ml = m[M_TRIM_E] - m[M_MSG_A];
    len += ml > 0 ? esc_len(chunk + base + m[M_MSG_A], ml) : 1;  // "-"
    len += sizeof("\",\"timestamp\":") - 1;
    len += m[M_TS_LEN];
    len += sizeof(",\"version\":\"1.1\"}") - 1;
    len += a.suffix_len;
    if (a.syslen) len += dec_digits(len) + 1;   // "NNN " prefix
    return len;
}

uint8_t* gelf_row_write(const GelfArgs& a, int64_t r, uint8_t* dst,
                        int64_t framed_len) {
    const int32_t* m = a.meta + r * M_NCOL;
    const uint8_t* chunk = a.chunk;
    int64_t base = m[M_START];
    if (a.syslen) dst = put_syslen_prefix(dst, framed_len);
    *dst++ = '{';
    int p = m[M_NPAIR];
    if (p > 0) {
        const int32_t* ns = a.pns + r * a.P;
        const int32_t* ne = a.pne + r * a.P;
        const int32_t* vs = a.pvs + r * a.P;
        const int32_t* ve = a.pve + r * a.P;
        const int32_t* pe = a.pesc + r * a.P;
        int order[kMaxPairs];
        int cnt = sort_pairs(chunk, base, ns, ne, p, order);
        for (int k = 0; k < cnt; k++) {
            int i = order[k];
            dst = LIT(dst, "\"_");
            dst = esc_write(dst, chunk + base + ns[i], ne[i] - ns[i]);
            dst = LIT(dst, "\":\"");
            dst = pe[i]
                ? esc_write_sd(dst, chunk + base + vs[i], ve[i] - vs[i])
                : esc_write(dst, chunk + base + vs[i], ve[i] - vs[i]);
            dst = LIT(dst, "\",");
        }
    }
    dst = LIT(dst, "\"application_name\":\"");
    dst = esc_write(dst, chunk + base + m[M_APP_S], m[M_APP_E] - m[M_APP_S]);
    dst = LIT(dst, "\",\"full_message\":\"");
    dst = esc_write(dst, chunk + base + m[M_FULL_S], m[M_TRIM_E] - m[M_FULL_S]);
    dst = LIT(dst, "\",\"host\":\"");
    int64_t hl = m[M_HOST_E] - m[M_HOST_S];
    if (hl) dst = esc_write(dst, chunk + base + m[M_HOST_S], hl);
    else dst = LIT(dst, "unknown");
    dst = LIT(dst, "\",\"level\":");
    *dst++ = (uint8_t)('0' + m[M_SEV]);
    dst = LIT(dst, ",\"process_id\":\"");
    dst = esc_write(dst, chunk + base + m[M_PROC_S], m[M_PROC_E] - m[M_PROC_S]);
    if (m[M_NSD]) {
        dst = LIT(dst, "\",\"sd_id\":\"");
        dst = esc_write(dst, chunk + base + m[M_SID_S], m[M_SID_E] - m[M_SID_S]);
    }
    dst = LIT(dst, "\",\"short_message\":\"");
    int64_t ml = m[M_TRIM_E] - m[M_MSG_A];
    if (ml > 0) dst = esc_write(dst, chunk + base + m[M_MSG_A], ml);
    else *dst++ = '-';
    dst = LIT(dst, "\",\"timestamp\":");
    dst = put(dst, (const char*)a.ts_scratch + m[M_TS_OFF],
              (size_t)m[M_TS_LEN]);
    dst = LIT(dst, ",\"version\":\"1.1\"}");
    if (a.suffix_len)
        dst = put(dst, (const char*)a.suffix, (size_t)a.suffix_len);
    return dst;
}

void run_threaded(int64_t n, int n_threads,
                  const std::function<void(int64_t, int64_t)>& work,
                  int64_t min_n = 4096) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1 || n < min_n) {
        work(0, n);
        return;
    }
    std::vector<std::thread> threads;
    int64_t per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        int64_t lo = t * per;
        int64_t hi = std::min<int64_t>(lo + per, n);
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void fg_gelf_lens_v2(const uint8_t* chunk, const int32_t* meta, int64_t R,
                  const int32_t* pns, const int32_t* pne,
                  const int32_t* pvs, const int32_t* pve,
                  const int32_t* pesc, int32_t P,
                  const uint8_t* ts_scratch,
                  const uint8_t* suffix, int32_t suffix_len, int32_t syslen,
                  int64_t* out_lens, int n_threads) {
    GelfArgs a{chunk, meta, R, pns, pne, pvs, pve, pesc, P,
               ts_scratch, suffix, suffix_len, syslen};
    run_threaded(R, n_threads, [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; r++) out_lens[r] = gelf_row_len(a, r);
    });
}

void fg_gelf_write_v2(const uint8_t* chunk, const int32_t* meta, int64_t R,
                   const int32_t* pns, const int32_t* pne,
                   const int32_t* pvs, const int32_t* pve,
                   const int32_t* pesc, int32_t P,
                   const uint8_t* ts_scratch,
                   const uint8_t* suffix, int32_t suffix_len, int32_t syslen,
                   const int64_t* out_off, uint8_t* dst, int n_threads) {
    GelfArgs a{chunk, meta, R, pns, pne, pvs, pve, pesc, P,
               ts_scratch, suffix, suffix_len, syslen};
    run_threaded(R, n_threads, [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; r++)
            gelf_row_write(a, r, dst + out_off[r], out_off[r + 1] - out_off[r]);
    });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Columnar RFC5424 -> RFC5424 re-encode row assembly
// (rfc5424_encoder.rs:28-93 semantics, batched): "<pri>1 ts host app
// proc msgid sd msg" from raw spans — no escaping, no sorting (SD
// blocks and pairs re-emit in original order, values verbatim per the
// reference's Display).  Same two-phase contract as the GELF assembler.
// rowmeta columns (int32, [R, R5_NCOL]); spans row-relative:
// ---------------------------------------------------------------------------

namespace {

enum {
    R5_START = 0, R5_PRI, R5_HOST_S, R5_HOST_E, R5_APP_S, R5_APP_E,
    R5_PROC_S, R5_PROC_E, R5_MSGID_S, R5_MSGID_E, R5_MSG_A, R5_TRIM_E,
    R5_NSD, R5_NPAIR, R5_TS_OFF, R5_TS_LEN, R5_NCOL
};

struct R5Args {
    const uint8_t* chunk;
    const int32_t* meta;
    int64_t R;
    const int32_t* sid_s;   // [R, SD]
    const int32_t* sid_e;
    int32_t SD;
    const int32_t* pns;     // [R, P]
    const int32_t* pne;
    const int32_t* pvs;
    const int32_t* pve;
    const int32_t* psd;     // pair -> block ordinal
    int32_t P;
    const uint8_t* ts_scratch;
    const uint8_t* suffix;
    int32_t suffix_len;
    int32_t syslen;
};

int64_t r5_row_len(const R5Args& a, int64_t r) {
    const int32_t* m = a.meta + r * R5_NCOL;
    int64_t len = 1 + dec_digits(m[R5_PRI]) + 2;     // '<' pri '>' '1'
    len += 1 + m[R5_TS_LEN];                         // ' ' ts
    len += 1 + (m[R5_HOST_E] - m[R5_HOST_S]);
    len += 1 + (m[R5_APP_E] - m[R5_APP_S]);
    len += 1 + (m[R5_PROC_E] - m[R5_PROC_S]);
    len += 1 + (m[R5_MSGID_E] - m[R5_MSGID_S]);
    len += 1;                                        // ' ' before sd
    int nsd = m[R5_NSD];
    if (nsd == 0) {
        len += 1;                                    // '-'
    } else {
        const int32_t* ss = a.sid_s + r * a.SD;
        const int32_t* se = a.sid_e + r * a.SD;
        for (int k = 0; k < nsd; k++)
            len += 2 + (se[k] - ss[k]);              // '[' sid ']'
        const int32_t* ns = a.pns + r * a.P;
        const int32_t* ne = a.pne + r * a.P;
        const int32_t* vs = a.pvs + r * a.P;
        const int32_t* ve = a.pve + r * a.P;
        for (int j = 0; j < m[R5_NPAIR]; j++)
            len += 1 + (ne[j] - ns[j]) + 2 + (ve[j] - vs[j]) + 1;
    }
    len += 1 + (m[R5_TRIM_E] - m[R5_MSG_A]);         // ' ' msg
    len += a.suffix_len;
    if (a.syslen) len += dec_digits(len) + 1;
    return len;
}

uint8_t* r5_row_write(const R5Args& a, int64_t r, uint8_t* dst,
                      int64_t framed_len) {
    const int32_t* m = a.meta + r * R5_NCOL;
    const uint8_t* chunk = a.chunk;
    int64_t base = m[R5_START];
    if (a.syslen) dst = put_syslen_prefix(dst, framed_len);
    *dst++ = '<';
    {
        char buf[8];
        int nb = snprintf(buf, sizeof buf, "%d", m[R5_PRI]);
        dst = put(dst, buf, (size_t)nb);
    }
    dst = LIT(dst, ">1 ");
    dst = put(dst, (const char*)a.ts_scratch + m[R5_TS_OFF],
              (size_t)m[R5_TS_LEN]);
    *dst++ = ' ';
    dst = put(dst, (const char*)chunk + base + m[R5_HOST_S],
              (size_t)(m[R5_HOST_E] - m[R5_HOST_S]));
    *dst++ = ' ';
    dst = put(dst, (const char*)chunk + base + m[R5_APP_S],
              (size_t)(m[R5_APP_E] - m[R5_APP_S]));
    *dst++ = ' ';
    dst = put(dst, (const char*)chunk + base + m[R5_PROC_S],
              (size_t)(m[R5_PROC_E] - m[R5_PROC_S]));
    *dst++ = ' ';
    dst = put(dst, (const char*)chunk + base + m[R5_MSGID_S],
              (size_t)(m[R5_MSGID_E] - m[R5_MSGID_S]));
    *dst++ = ' ';
    int nsd = m[R5_NSD];
    if (nsd == 0) {
        *dst++ = '-';
    } else {
        const int32_t* ss = a.sid_s + r * a.SD;
        const int32_t* se = a.sid_e + r * a.SD;
        const int32_t* ns = a.pns + r * a.P;
        const int32_t* ne = a.pne + r * a.P;
        const int32_t* vs = a.pvs + r * a.P;
        const int32_t* ve = a.pve + r * a.P;
        const int32_t* psd = a.psd + r * a.P;
        int npair = m[R5_NPAIR];
        int j = 0;
        for (int k = 0; k < nsd; k++) {
            *dst++ = '[';
            dst = put(dst, (const char*)chunk + base + ss[k],
                      (size_t)(se[k] - ss[k]));
            for (; j < npair && psd[j] == k; j++) {
                *dst++ = ' ';
                dst = put(dst, (const char*)chunk + base + ns[j],
                          (size_t)(ne[j] - ns[j]));
                dst = LIT(dst, "=\"");
                dst = put(dst, (const char*)chunk + base + vs[j],
                          (size_t)(ve[j] - vs[j]));
                *dst++ = '"';
            }
            *dst++ = ']';
        }
    }
    *dst++ = ' ';
    dst = put(dst, (const char*)chunk + base + m[R5_MSG_A],
              (size_t)(m[R5_TRIM_E] - m[R5_MSG_A]));
    if (a.suffix_len)
        dst = put(dst, (const char*)a.suffix, (size_t)a.suffix_len);
    return dst;
}

}  // namespace

extern "C" {

void fg_r5_lens(const uint8_t* chunk, const int32_t* meta, int64_t R,
                const int32_t* sid_s, const int32_t* sid_e, int32_t SD,
                const int32_t* pns, const int32_t* pne,
                const int32_t* pvs, const int32_t* pve,
                const int32_t* psd, int32_t P,
                const uint8_t* ts_scratch,
                const uint8_t* suffix, int32_t suffix_len, int32_t syslen,
                int64_t* out_lens, int n_threads) {
    R5Args a{chunk, meta, R, sid_s, sid_e, SD, pns, pne, pvs, pve, psd,
             P, ts_scratch, suffix, suffix_len, syslen};
    run_threaded(R, n_threads, [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; r++) out_lens[r] = r5_row_len(a, r);
    });
}

void fg_r5_write(const uint8_t* chunk, const int32_t* meta, int64_t R,
                 const int32_t* sid_s, const int32_t* sid_e, int32_t SD,
                 const int32_t* pns, const int32_t* pne,
                 const int32_t* pvs, const int32_t* pve,
                 const int32_t* psd, int32_t P,
                 const uint8_t* ts_scratch,
                 const uint8_t* suffix, int32_t suffix_len, int32_t syslen,
                 const int64_t* out_off, uint8_t* dst, int n_threads) {
    R5Args a{chunk, meta, R, sid_s, sid_e, SD, pns, pne, pvs, pve, psd,
             P, ts_scratch, suffix, suffix_len, syslen};
    run_threaded(R, n_threads, [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; r++)
            r5_row_write(a, r, dst + out_off[r],
                         out_off[r + 1] - out_off[r]);
    });
}

}  // extern "C"

extern "C" {

// Concatenate segments of src into dst: segment i copies
// src[seg_src[i] .. seg_src[i]+seg_len[i]) to dst[dst_off[i]).
// dst_off is the exclusive prefix sum of seg_len (computed by the
// caller, which lets worker threads start mid-stream).  This is the
// byte-assembly engine of the columnar encode path
// (flowgger_tpu_torch/tpu/assemble.py).
void fg_concat_segments(const uint8_t* src,
                        const int64_t* seg_src, const int64_t* seg_len,
                        const int64_t* dst_off, int64_t nseg,
                        uint8_t* dst, int n_threads) {
    run_threaded(nseg, n_threads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            int64_t len = seg_len[i];
            if (len > 0)
                memcpy(dst + dst_off[i], src + seg_src[i], (size_t)len);
        }
    }, 8192);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// serde_json-style f64 formatting (utils/rustfmt.py json_f64 semantics):
// shortest round-trip digits via std::to_chars, re-rendered with the
// CPython-repr notation rule (fixed for 10^-4 <= |v| < 10^16, keeping
// ".0" on integral values; otherwise "dE" exponent form without '+' or
// leading exponent zeros; non-finite -> "null").  Differentially fuzz-
// tested against the Python oracle in tests/test_torch_native.py.
// ---------------------------------------------------------------------------

namespace {

int json_f64_render(double v, char* out) {
    if (std::isnan(v) || std::isinf(v)) {
        memcpy(out, "null", 4);
        return 4;
    }
    char buf[40];
    auto r = std::to_chars(buf, buf + sizeof(buf), v,
                           std::chars_format::scientific);
    const char* p = buf;
    char* o = out;
    if (*p == '-') { *o++ = '-'; p++; }
    char digits[24];
    int nd = 0;
    while (p < r.ptr && *p != 'e') {
        if (*p != '.') digits[nd++] = *p;
        p++;
    }
    p++;  // 'e'
    int esign = 1;
    if (p < r.ptr && *p == '+') p++;
    else if (p < r.ptr && *p == '-') { esign = -1; p++; }
    int E = 0;
    while (p < r.ptr) E = E * 10 + (*p++ - '0');
    E *= esign;
    if (E >= -4 && E < 16) {
        if (E >= 0) {
            int i = 0;
            for (; i <= E; i++) *o++ = i < nd ? digits[i] : '0';
            *o++ = '.';
            if (i < nd) { for (; i < nd; i++) *o++ = digits[i]; }
            else *o++ = '0';
        } else {
            *o++ = '0';
            *o++ = '.';
            for (int z = 0; z < -E - 1; z++) *o++ = '0';
            for (int i = 0; i < nd; i++) *o++ = digits[i];
        }
    } else {
        *o++ = digits[0];
        if (nd > 1) {
            *o++ = '.';
            for (int i = 1; i < nd; i++) *o++ = digits[i];
        }
        *o++ = 'e';
        if (E < 0) { *o++ = '-'; E = -E; }
        char eb[8];
        int ne = 0;
        do { eb[ne++] = (char)('0' + E % 10); E /= 10; } while (E);
        while (ne) *o++ = eb[--ne];
    }
    return (int)(o - out);
}

}  // namespace

extern "C" {

// Format n doubles into a dense [n, width] byte matrix (rows zero-
// padded) + per-row byte lengths.  Rows whose rendering would exceed
// `width` get length 0 (callers treat that as "fall back this row");
// json_f64 output is at most 24 bytes so any width >= 24 never clips.
void fg_format_f64_json(const double* vals, int64_t n, uint8_t* out,
                        int32_t width, int32_t* out_len, int n_threads) {
    run_threaded(n, n_threads, [&](int64_t lo, int64_t hi) {
        char buf[48];
        for (int64_t i = lo; i < hi; i++) {
            int len = json_f64_render(vals[i], buf);
            uint8_t* row = out + (size_t)i * (size_t)width;
            if (len > width) {
                memset(row, 0, (size_t)width);
                out_len[i] = 0;
                continue;
            }
            memcpy(row, buf, (size_t)len);
            if (len < width) memset(row + len, 0, (size_t)(width - len));
            out_len[i] = (int32_t)len;
        }
    }, 16384);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli) — required by the Kafka record-batch v2 format.
// Table-driven, slicing-by-4.
// ---------------------------------------------------------------------------

namespace {

struct Crc32cTables {
    uint32_t t[4][256];
    Crc32cTables() {
        const uint32_t poly = 0x82F63B78u;  // reflected 0x1EDC6F41
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++)
                c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
            t[0][i] = c;
        }
        for (uint32_t i = 0; i < 256; i++) {
            t[1][i] = (t[0][i] >> 8) ^ t[0][t[0][i] & 0xFF];
            t[2][i] = (t[1][i] >> 8) ^ t[0][t[1][i] & 0xFF];
            t[3][i] = (t[2][i] >> 8) ^ t[0][t[2][i] & 0xFF];
        }
    }
};
const Crc32cTables kCrc;

}  // namespace

extern "C" {

uint32_t fg_crc32c(const uint8_t* data, int64_t len, uint32_t init) {
    uint32_t c = ~init;
    int64_t i = 0;
    for (; i + 4 <= len; i += 4) {
        c ^= (uint32_t)data[i] | ((uint32_t)data[i + 1] << 8)
             | ((uint32_t)data[i + 2] << 16) | ((uint32_t)data[i + 3] << 24);
        c = kCrc.t[3][c & 0xFF] ^ kCrc.t[2][(c >> 8) & 0xFF]
            ^ kCrc.t[1][(c >> 16) & 0xFF] ^ kCrc.t[0][c >> 24];
    }
    for (; i < len; i++)
        c = (c >> 8) ^ kCrc.t[0][(c ^ data[i]) & 0xFF];
    return ~c;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Snappy block format (raw, no framing) — the compression codec Kafka
// record batches use for attributes=2.  Greedy 64KB-block hash matching
// per the public format description; decompressor handles every element
// type.
// ---------------------------------------------------------------------------

namespace {

inline int put_varint(uint8_t* dst, uint64_t v) {
    int n = 0;
    while (v >= 0x80) {
        dst[n++] = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    dst[n++] = (uint8_t)v;
    return n;
}

inline uint8_t* emit_literal(uint8_t* op, const uint8_t* s, int64_t len) {
    int64_t n = len - 1;
    if (n < 60) {
        *op++ = (uint8_t)(n << 2);
    } else if (n < 256) {
        *op++ = (uint8_t)(60 << 2);
        *op++ = (uint8_t)n;
    } else if (n < 65536) {
        *op++ = (uint8_t)(61 << 2);
        *op++ = (uint8_t)n;
        *op++ = (uint8_t)(n >> 8);
    } else if (n < (1 << 24)) {
        *op++ = (uint8_t)(62 << 2);
        *op++ = (uint8_t)n;
        *op++ = (uint8_t)(n >> 8);
        *op++ = (uint8_t)(n >> 16);
    } else {
        *op++ = (uint8_t)(63 << 2);
        *op++ = (uint8_t)n;
        *op++ = (uint8_t)(n >> 8);
        *op++ = (uint8_t)(n >> 16);
        *op++ = (uint8_t)(n >> 24);
    }
    memcpy(op, s, (size_t)len);
    return op + len;
}

inline uint8_t* emit_copy(uint8_t* op, int64_t offset, int64_t len) {
    // len 4..11 with offset < 2048: 1-byte-offset form
    while (len >= 68) {
        *op++ = (uint8_t)((63 << 2) | 2);  // copy-2, len 64
        *op++ = (uint8_t)offset;
        *op++ = (uint8_t)(offset >> 8);
        len -= 64;
    }
    if (len > 64) {
        *op++ = (uint8_t)((59 << 2) | 2);  // len 60
        *op++ = (uint8_t)offset;
        *op++ = (uint8_t)(offset >> 8);
        len -= 60;
    }
    if (len >= 12 || offset >= 2048) {
        *op++ = (uint8_t)(((len - 1) << 2) | 2);
        *op++ = (uint8_t)offset;
        *op++ = (uint8_t)(offset >> 8);
    } else {
        *op++ = (uint8_t)(((offset >> 8) << 5) | ((len - 4) << 2) | 1);
        *op++ = (uint8_t)offset;
    }
    return op;
}

inline uint32_t snappy_hash(uint32_t v) { return (v * 0x1E35A7BDu) >> 18; }

}  // namespace

extern "C" {

int64_t fg_snappy_max_compressed(int64_t n) {
    return 32 + n + n / 6;
}

// Compress src into dst (sized >= fg_snappy_max_compressed); returns the
// compressed size.
int64_t fg_snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst) {
    uint8_t* op = dst;
    op += put_varint(op, (uint64_t)n);
    const int64_t kBlock = 1 << 16;
    std::vector<uint16_t> table(1 << 14);
    for (int64_t base = 0; base < n; base += kBlock) {
        int64_t blen = std::min(kBlock, n - base);
        const uint8_t* p = src + base;
        std::fill(table.begin(), table.end(), 0);
        int64_t ip = 0;
        int64_t lit_start = 0;
        while (ip + 4 <= blen) {
            uint32_t v;
            memcpy(&v, p + ip, 4);
            uint32_t h = snappy_hash(v);
            int64_t cand = table[h];
            table[h] = (uint16_t)ip;
            uint32_t cv;
            memcpy(&cv, p + cand, 4);
            if (cand < ip && cv == v) {
                // extend the match
                int64_t len = 4;
                while (ip + len < blen && p[cand + len] == p[ip + len]
                       && len < (int64_t)0xFFFF)
                    len++;
                if (ip > lit_start)
                    op = emit_literal(op, p + lit_start, ip - lit_start);
                op = emit_copy(op, ip - cand, len);
                ip += len;
                lit_start = ip;
            } else {
                ip++;
            }
        }
        if (blen > lit_start)
            op = emit_literal(op, p + lit_start, blen - lit_start);
    }
    return op - dst;
}

// Decompress src into dst (sized to the preamble's uncompressed length).
// Returns the decompressed size, or -1 on malformed input.
int64_t fg_snappy_decompress(const uint8_t* src, int64_t n,
                             uint8_t* dst, int64_t dst_cap) {
    int64_t ip = 0;
    uint64_t ulen = 0;
    int shift = 0;
    while (ip < n) {
        uint8_t b = src[ip++];
        ulen |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
        if (shift > 35) return -1;
    }
    if ((int64_t)ulen > dst_cap) return -1;
    int64_t op = 0;
    while (ip < n) {
        uint8_t tag = src[ip++];
        int type = tag & 3;
        if (type == 0) {  // literal
            int64_t len = (tag >> 2) + 1;
            if (len > 60) {
                int nb = (int)len - 60;
                if (ip + nb > n) return -1;
                len = 0;
                for (int k = 0; k < nb; k++)
                    len |= (int64_t)src[ip + k] << (8 * k);
                len += 1;
                ip += nb;
            }
            if (ip + len > n || op + len > (int64_t)ulen) return -1;
            memcpy(dst + op, src + ip, (size_t)len);
            ip += len;
            op += len;
            continue;
        }
        int64_t len, offset;
        if (type == 1) {
            if (ip >= n) return -1;
            len = ((tag >> 2) & 7) + 4;
            offset = ((int64_t)(tag >> 5) << 8) | src[ip++];
        } else if (type == 2) {
            if (ip + 2 > n) return -1;
            len = (tag >> 2) + 1;
            offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
            ip += 2;
        } else {
            if (ip + 4 > n) return -1;
            len = (tag >> 2) + 1;
            offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8)
                     | ((int64_t)src[ip + 2] << 16)
                     | ((int64_t)src[ip + 3] << 24);
            ip += 4;
        }
        if (offset == 0 || offset > op || op + len > (int64_t)ulen) return -1;
        // overlapping copies are byte-serial by definition
        for (int64_t k = 0; k < len; k++) {
            dst[op + k] = dst[op + k - offset];
        }
        op += len;
    }
    return op == (int64_t)ulen ? op : -1;
}

}  // extern "C"
