// Self-test program for the port's native host tier
// (flowgger_tpu_torch/csrc/flowgger_host.cpp), a trimmed copy of the JAX
// package's native/test_host.cpp without the cases of the exports the
// copy leaves out (line and syslen scans, dense pack, crc32c, snappy),
// plus a GELF-rows case.  tests/test_torch_native.py builds it with
// -fsanitize=address,undefined and runs it — sanitizers need a runnable
// binary, not a shared library loaded into an unsanitized python.

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
void fg_concat_segments(const uint8_t*, const int64_t*, const int64_t*,
                        const int64_t*, int64_t, uint8_t*, int);
void fg_gelf_lens_v2(const uint8_t*, const int32_t*, int64_t,
                     const int32_t*, const int32_t*, const int32_t*,
                     const int32_t*, const int32_t*, int32_t,
                     const uint8_t*, const uint8_t*, int32_t, int32_t,
                     int64_t*, int);
void fg_gelf_write_v2(const uint8_t*, const int32_t*, int64_t,
                      const int32_t*, const int32_t*, const int32_t*,
                      const int32_t*, const int32_t*, int32_t,
                      const uint8_t*, const uint8_t*, int32_t, int32_t,
                      const int64_t*, uint8_t*, int);
void fg_format_f64_json(const double*, int64_t, uint8_t*, int32_t,
                        int32_t*, int);
}

int main() {
    // a chunk of 10000 lines (CRLF every third line) and their spans
    std::string chunk;
    const int64_t n = 10000;
    std::vector<int32_t> starts(n), lens(n);
    for (int64_t i = 0; i < n; i++) {
        std::string line = "line number " + std::to_string(i);
        starts[i] = (int32_t)chunk.size();
        lens[i] = (int32_t)line.size();
        chunk += line;
        chunk += (i % 3 == 0) ? "\r\n" : "\n";
    }
    // threaded segment concat: interleave two sources of the chunk
    {
        int64_t nseg = 2 * n;
        std::vector<int64_t> seg_src(nseg), seg_len(nseg), dst_off(nseg + 1);
        int64_t pos = 0;
        for (int64_t i = 0; i < n; i++) {
            seg_src[2 * i] = starts[i];
            seg_len[2 * i] = lens[i];
            seg_src[2 * i + 1] = starts[0];
            seg_len[2 * i + 1] = 4;  // "line"
        }
        for (int64_t i = 0; i < nseg; i++) {
            dst_off[i] = pos;
            pos += seg_len[i];
        }
        dst_off[nseg] = pos;
        std::vector<uint8_t> cat(pos);
        fg_concat_segments((const uint8_t*)chunk.data(), seg_src.data(),
                           seg_len.data(), dst_off.data(), nseg, cat.data(), 8);
        assert(memcmp(cat.data() + dst_off[1], "line", 4) == 0);
        assert(memcmp(cat.data(), chunk.data(), (size_t)lens[0]) == 0);
    }

    // threaded GELF row engine: 5000 copies of one row whose SD pairs
    // hold a value that needs the SD unescape and a duplicated name
    // (dict last-wins), so the sort, the dedup and both escapes run
    // under the sanitizers, with line and syslen framing
    {
        const std::string row = "H A 42 SID e=a\\]b\\\\c k=1 z=x k=2 full message";
        auto at = [&](const char* s) { return (int32_t)row.find(s); };
        const int64_t R = 5000;
        std::string chunk2;
        for (int64_t r = 0; r < R; r++) chunk2 += row;
        const int32_t P = 4;
        std::vector<int32_t> meta(R * 17), ns(R * P), ne(R * P), vs(R * P),
            ve(R * P), esc(R * P);
        const char* names[P] = {"e=", "k=1", "z=", "k=2"};
        const int32_t vlen[P] = {7, 1, 1, 1};
        for (int64_t r = 0; r < R; r++) {
            int32_t* m = meta.data() + r * 17;
            int32_t full = at("full"), end = (int32_t)row.size();
            int32_t v[17] = {(int32_t)(r * row.size()), at("H"), at("H") + 1,
                             at("A"), at("A") + 1, at("42"), at("42") + 2,
                             at("message"), end, full, 5, 1, at("SID"),
                             at("SID") + 3, 0, 3, P};
            memcpy(m, v, sizeof v);
            for (int p = 0; p < P; p++) {
                int32_t s = at(names[p]);
                ns[r * P + p] = s;
                ne[r * P + p] = s + 1;
                vs[r * P + p] = s + 2;
                ve[r * P + p] = vs[r * P + p] + vlen[p];
                esc[r * P + p] = p == 0;
            }
        }
        const std::string body =
            "{\"_e\":\"a]b\\\\c\",\"_k\":\"2\",\"_z\":\"x\","
            "\"application_name\":\"A\",\"full_message\":\"full message\","
            "\"host\":\"H\",\"level\":5,\"process_id\":\"42\","
            "\"sd_id\":\"SID\",\"short_message\":\"message\","
            "\"timestamp\":1.5,\"version\":\"1.1\"}\n";
        const uint8_t ts[] = "1.5";
        const uint8_t nl[] = "\n";
        for (int syslen = 0; syslen <= 1; syslen++) {
            const std::string want = syslen
                ? std::to_string(body.size()) + " " + body : body;
            std::vector<int64_t> lens(R), off(R + 1, 0);
            fg_gelf_lens_v2((const uint8_t*)chunk2.data(), meta.data(), R,
                            ns.data(), ne.data(), vs.data(), ve.data(),
                            esc.data(), P, ts, nl, 1, syslen, lens.data(), 8);
            for (int64_t r = 0; r < R; r++) {
                assert(lens[r] == (int64_t)want.size());
                off[r + 1] = off[r] + lens[r];
            }
            std::vector<uint8_t> out((size_t)off[R]);
            fg_gelf_write_v2((const uint8_t*)chunk2.data(), meta.data(), R,
                             ns.data(), ne.data(), vs.data(), ve.data(),
                             esc.data(), P, ts, nl, 1, syslen, off.data(),
                             out.data(), 8);
            for (int64_t r = 0; r < R; r++)
                assert(memcmp(out.data() + off[r], want.data(),
                              want.size()) == 0);
        }
    }

    // threaded f64 JSON formatter (shortest round-trip, json_f64
    // notation): spot values + a threaded batch under the sanitizers
    {
        std::vector<double> vals = {1438790025.637824, 0.0, -0.0, 1e16,
                                    0.0001, 1e-5, 5e-324,
                                    1.7976931348623157e308};
        for (int i = 0; i < 40000; i++)
            vals.push_back(1.0e9 + i * 0.001 + i);
        int64_t nv = (int64_t)vals.size();
        std::vector<uint8_t> txt((size_t)nv * 32);
        std::vector<int32_t> tlen(nv);
        fg_format_f64_json(vals.data(), nv, txt.data(), 32, tlen.data(), 4);
        auto row = [&](int64_t i) {
            return std::string((const char*)txt.data() + i * 32,
                               (size_t)tlen[i]);
        };
        assert(row(0) == "1438790025.637824");
        assert(row(1) == "0.0");
        assert(row(2) == "-0.0");
        assert(row(3) == "1e16");
        assert(row(4) == "0.0001");
        assert(row(5) == "1e-5");
        assert(row(6) == "5e-324");
        for (int64_t i = 0; i < nv; i++) {
            assert(tlen[i] >= 1 && tlen[i] <= 32);
            double back = strtod(row(i).c_str(), nullptr);
            assert(back == vals[i] || (vals[i] != vals[i]));
        }
    }

    printf("native self-test ok: %lld lines\n", (long long)n);
    return 0;
}
