// emsar_jax native ingest: alignment streaming + signature collapse.
//
// C++ replacement for the reference's alignment ingestion stack
// (bowtie/SAM/BAM readers + per-read alignment lists + signature read
// counting; reference: src/emsar_functions.c:210-943, src/alignment.c,
// vendored samtools bgzf.c/bam.c).  Exposed through a C ABI consumed via
// ctypes (emsar_jax/ingest/native.py).
//
// Semantics (must match the Python path bit-for-bit):
//  * per read: dedup identical (tid,pos,fraglen); keep only min-mismatch
//    alignments; discard reads with > max_repeat alignments; PE fraglen
//    discrepancy discards the read
//  * count single signatures only when the tid has a single-EUMA node;
//    multi signatures only when present in the index
//  * every in-range read enters TotalReadCount + the fraglen histogram
//
// Build: g++ -O3 -std=c++20 -shared -fPIC ingest.cc -o libemsar_ingest.so -lz

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <thread>
#include <vector>

namespace {

// heterogeneous lookup: find() with string_view, no temporary std::string
struct SvHash {
    using is_transparent = void;
    size_t operator()(std::string_view s) const {
        return std::hash<std::string_view>{}(s);
    }
};

struct SigTable {
    // bytes of sorted int32 multiset -> row id
    std::unordered_map<std::string, int64_t, SvHash, std::equal_to<>> map;
    int64_t n = 0;
};

struct Counts {
    int64_t* single_counts;
    int64_t* multi_counts;
    int64_t* fraglen_counts;
    int64_t hist_size;
    int64_t total_read_count = 0;
    // positional-bias accumulation (-m 1, reference update_ReadCounts
    // posmodel blocks src/emsar_functions.c:852-934); pb_len == 0 disables.
    // pb_mark[t] accumulates the per-alignment weight of transcripts of
    // length t < pb_len; the caller suffix-sums it into the "unavailable
    // position" arrays (Python PosBias semantics, ingest/collapse.py).
    const int64_t* pb_tlen = nullptr;
    int64_t pb_len = 0;
    double* pb_freq5 = nullptr;
    double* pb_freq3 = nullptr;
    double* pb_mark = nullptr;
};

struct Aln {
    int32_t tid;
    int32_t mm;
    int32_t fraglen;
    int32_t pos;
};

struct Collapser {
    const SigTable* sigs;
    const uint8_t* has_single;
    int64_t min_frag, max_frag;
    int64_t max_repeat;
    bool pe;
    Counts* out;

    std::string cur_id;
    bool have_id = false;
    int cur_min_mm = 10000;
    std::vector<Aln> cur;
    std::vector<int32_t> tid_buf;

    void flush() {
        size_t n = cur.size();
        if (n == 0 || (int64_t)n > max_repeat) return;
        if (pe && n > 1) {
            for (size_t i = 1; i < n; i++)
                if (cur[i].fraglen != cur[0].fraglen) return;
        }
        int64_t fraglen = cur[0].fraglen;
        if (fraglen < min_frag || fraglen > max_frag) return;
        if (out->pb_len) {
            // per-alignment weight 1/n (Python PosBias.add; reference
            // perpos_freq accrual).  freq3's negative-offset wraparound
            // mirrors NumPy's negative indexing in the Python path.
            double w = 1.0 / (double)n;
            int64_t L = out->pb_len;
            for (auto& a : cur) {
                int64_t tlen = out->pb_tlen[a.tid];
                // a.pos can be negative on malformed input (SAM POS=0
                // becomes -1 after the 1-based conversion); mirror NumPy's
                // negative indexing like freq3 below instead of writing
                // out of bounds.
                int64_t p5 = (int64_t)a.pos;
                if (p5 < L) {
                    int64_t idx5 = p5 >= 0 ? p5 : L + (p5 > -L ? p5 : -L);
                    out->pb_freq5[idx5] += w;
                }
                int64_t d3 = tlen - ((int64_t)a.pos + a.fraglen - 1);
                if (d3 < L) {
                    int64_t idx = d3 >= 0 ? d3 : L + (d3 > -L ? d3 : -L);
                    out->pb_freq3[idx] += w;
                }
                if (tlen < L) out->pb_mark[tlen] += w;
            }
        }
        if (n == 1) {
            if (has_single[cur[0].tid]) out->single_counts[cur[0].tid]++;
        } else {
            tid_buf.clear();
            for (auto& a : cur) tid_buf.push_back(a.tid);
            std::sort(tid_buf.begin(), tid_buf.end());
            std::string_view key(
                reinterpret_cast<const char*>(tid_buf.data()),
                tid_buf.size() * sizeof(int32_t));
            auto it = sigs->map.find(key);
            if (it != sigs->map.end()) out->multi_counts[it->second]++;
        }
        if (fraglen < out->hist_size) out->fraglen_counts[fraglen]++;
        out->total_read_count++;
    }

    // feed one (read_id, alignment); alignment with tid < 0 means "parsed
    // but filtered" (strand / orientation) — skipped without breaking the
    // group, matching the reference's NULL handling.
    void feed(std::string_view read_id, const Aln& a) {
        if (a.tid < 0) return;
        if (!have_id || read_id != cur_id) {
            if (have_id) flush();
            cur_id.assign(read_id.data(), read_id.size());
            have_id = true;
            cur.clear();
            cur_min_mm = 10000;
        }
        for (auto& e : cur)
            if (e.tid == a.tid && e.pos == a.pos && e.fraglen == a.fraglen)
                return;  // exact duplicate
        if (a.mm > cur_min_mm) return;
        if (a.mm < cur_min_mm) {
            cur.clear();
            cur_min_mm = a.mm;
        }
        cur.push_back(a);
    }

    void finish() {
        if (have_id) flush();
        have_id = false;
    }
};

// ---------------------------------------------------------------------------
// line reader (plain files, arbitrarily long lines)
// ---------------------------------------------------------------------------

struct LineReader {
    FILE* fh;
    std::vector<char> buf;
    explicit LineReader(FILE* f) : fh(f), buf(1 << 16) {}
    // returns length or -1 at EOF; line is NUL-terminated, newline stripped
    ssize_t next(char** line) {
        size_t len = 0;
        while (true) {
            if (!fgets(buf.data() + len, (int)(buf.size() - len), fh)) {
                if (len == 0) return -1;
                break;
            }
            len += strlen(buf.data() + len);
            if (len > 0 && buf[len - 1] == '\n') {
                buf[--len] = '\0';
                break;
            }
            if (len + 1 >= buf.size()) buf.resize(buf.size() * 2);
            else break;  // EOF without newline
        }
        *line = buf.data();
        return (ssize_t)len;
    }
};

struct NameTable {
    std::unordered_map<std::string, int32_t, SvHash, std::equal_to<>> map;
    int64_t n = 0;
};

int32_t parse_i32(std::string_view s) {
    int32_t v = 0;
    bool neg = false;
    size_t i = 0;
    if (i < s.size() && (s[i] == '-' || s[i] == '+')) neg = s[i++] == '-';
    for (; i < s.size() && s[i] >= '0' && s[i] <= '9'; i++)
        v = v * 10 + (s[i] - '0');
    return neg ? -v : v;
}

int mm_from_mmstr(const char* s, size_t len) {
    if (len == 0) return 0;
    int mm = 1;
    for (size_t i = 0; i < len; i++)
        if (s[i] == ',') mm++;
    return mm;
}

int mm_from_md(const char* s) {
    if (!s) return 0;
    int mm = 0;
    for (; *s; s++)
        if (*s < '0' || *s > '9') mm++;
    return mm;
}

struct BowtieFields {
    std::string_view id, strandf, tname, mmstr;
    int32_t pos = 0;
    int32_t readlen = 0;
    int nfields = 0;
};

bool split_bowtie(char* line, ssize_t len, BowtieFields* f) {
    std::string_view fields[16];
    int n = 0;
    char* start = line;
    for (char* p = line;; p++) {
        if (*p == '\t' || *p == '\0') {
            if (n < 16) fields[n] = std::string_view(start, p - start);
            n++;
            if (*p == '\0') break;
            start = p + 1;
        }
    }
    f->nfields = n;
    if (n < 7) return false;
    f->id = fields[0];
    f->strandf = fields[1];
    f->tname = fields[2];
    f->pos = parse_i32(fields[3]);
    f->readlen = (int32_t)fields[4].size();
    f->mmstr = n > 7 ? fields[7] : std::string_view();
    return true;
}

// reference check_mate_readid_matching (src/alignment.c:113-126)
int mate_id_match(std::string_view a, std::string_view b) {
    if (a.size() != b.size()) return 0;
    size_t n = a.size();
    if (n >= 2 && a[n - 2] == '/' && b[n - 2] == '/' &&
        ((a[n - 1] == '1' && b[n - 1] == '2') ||
         (a[n - 1] == '2' && b[n - 1] == '1' &&
          a.substr(0, n - 2) == b.substr(0, n - 2))))
        return (int)(n - 2);
    for (size_t i = 0; i < n; i++) {
        if (a[i] == ' ' && b[i] == ' ') return (int)i;
        if (a[i] != b[i]) return 0;
    }
    return (int)n;
}

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

// budgeted line reader: reads at most `budget` bytes (line-aligned ranges;
// budget < 0 means unlimited)
struct RangeLineReader {
    LineReader rd;
    int64_t budget;
    bool truncated = false;  // last -1 came from the byte budget, not EOF
    RangeLineReader(FILE* f, int64_t b) : rd(f), budget(b) {}
    ssize_t next(char** line) {
        if (budget == 0) { truncated = true; return -1; }
        ssize_t len = rd.next(line);
        if (len < 0) { truncated = false; return len; }
        if (budget > 0) {
            budget -= len + 1;
            if (budget < 0) budget = 0;
        }
        return len;
    }
};

// Strict mate check for the boundary scan: unlike the reference's
// asymmetric quirk (mate_id_match accepts any same-length '.../1','.../2'
// without comparing prefixes, src/alignment.c:113-126), the scan also
// compares prefixes in that case — otherwise a mate2-first-ordered file
// with uniform-length ids never yields a boundary and parallel ingest
// silently degrades to one effective worker.  Workers still apply the
// quirky reference check; a stricter boundary only splits *between* real
// pairs, so results are unchanged.
int mate_id_match_strict(std::string_view a, std::string_view b) {
    size_t n = a.size();
    if (n >= 2 && n == b.size() && a[n - 2] == '/' && b[n - 2] == '/' &&
        a[n - 1] == '1' && b[n - 1] == '2' &&
        a.substr(0, n - 2) != b.substr(0, n - 2))
        return 0;
    return mate_id_match(a, b);
}

// first byte offset at or after `from` that starts a new read group
// (SE: read id differs from the previous line's; PE: ids are not mates)
int64_t bowtie_group_boundary(FILE* fh, int64_t from, int64_t fsize, int pe) {
    if (from <= 0) return 0;
    fseeko(fh, (off_t)from, SEEK_SET);
    LineReader rd(fh);
    char* line;
    // discard the (possibly partial) line containing `from`
    ssize_t len = rd.next(&line);
    if (len < 0) return fsize;
    int64_t off = from + len + 1;
    std::string prev_id;
    while (off < fsize) {
        len = rd.next(&line);
        if (len < 0) return fsize;
        const char* tab = (const char*)memchr(line, '\t', (size_t)len);
        std::string_view id(line, tab ? (size_t)(tab - line) : (size_t)len);
        if (!prev_id.empty()) {
            bool same =
                pe ? mate_id_match_strict(prev_id, id) != 0 : id == prev_id;
            if (!same) return off;
        }
        prev_id.assign(id.data(), id.size());
        off += len + 1;
    }
    return fsize;
}

// full parse+collapse pipeline over one line-aligned byte range
int bowtie_worker(FILE* fh, int64_t budget, int pe, int strand_code,
                  int64_t max_repeat, int64_t min_frag, int64_t max_frag,
                  const NameTable* names, const SigTable* sigs,
                  const uint8_t* has_single, Counts& counts,
                  int64_t* readlength_io) {
    Collapser col{sigs, has_single, min_frag, max_frag, max_repeat, pe != 0,
                  &counts};
    RangeLineReader rd(fh, budget);
    char* line;
    int64_t readlength = *readlength_io;
    int rc = 0;
    std::string pair_id;

    if (!pe) {
        BowtieFields f;
        while (rd.next(&line) >= 0) {
            if (!split_bowtie(line, 0, &f)) {
                set_error("input alignment file doesn't look like bowtieout "
                          "file");
                rc = -2;
                break;
            }
            if (strand_code != 0 &&
                (f.strandf.empty() || f.strandf[0] != (char)strand_code))
                continue;
            auto it = names->map.find(f.tname);
            if (it == names->map.end()) {
                set_error("unexisting transcript '" + std::string(f.tname) +
                          "' in the bowtie output file");
                rc = -3;
                break;
            }
            col.feed(f.id, Aln{it->second,
                               mm_from_mmstr(f.mmstr.data(), f.mmstr.size()),
                               f.readlen, f.pos});
        }
    } else {
        BowtieFields f1, f2;
        std::vector<char> line1buf;
        while (rd.next(&line) >= 0) {
            line1buf.assign(line, line + strlen(line) + 1);
            if (rd.next(&line) < 0) {
                // A worker's byte range may only end at a read-group
                // boundary; running out of budget mid-pair means the
                // boundary scan failed — fail loudly instead of silently
                // dropping the dangling line (thread-count-independent
                // behavior).  At true EOF the dangling line is skipped:
                // the reference parses a stale buffer there (UB,
                // src/emsar_functions.c:810 fgets return unchecked).
                if (rd.truncated) {
                    set_error("paired-end range split mid-pair; mate read "
                              "IDs don't match; check bowtie out format");
                    rc = -4;
                }
                break;
            }
            if (!split_bowtie(line1buf.data(), 0, &f1) ||
                !split_bowtie(line, 0, &f2)) {
                set_error("input alignment file doesn't look like bowtieout "
                          "file");
                rc = -2;
                break;
            }
            int matched = mate_id_match(f1.id, f2.id);
            if (matched == 0) {
                set_error("mate read IDs don't match; check bowtie out "
                          "format");
                rc = -4;
                break;
            }
            // reference quirk (src/emsar_functions.c:652): mates swap
            // unless the id's last char is the byte 0x01
            bool order_reversed = !(f1.id.size() && f1.id.back() == '\x01');
            pair_id.assign(f1.id.substr(0, matched));

            std::string_view s1 = f1.strandf, s2 = f2.strandf;
            int32_t p1 = f1.pos, p2 = f2.pos;
            std::string_view m1 = f1.mmstr, m2 = f2.mmstr;
            if (order_reversed) {
                std::swap(p1, p2);
                std::swap(s1, s2);
                std::swap(m1, m2);
            }
            if (f1.tname != f2.tname) continue;
            if (readlength == -1) readlength = f1.readlen;
            if (readlength != f1.readlen || readlength != f2.readlen) {
                set_error("paired-end data with variable read length is not "
                          "supported");
                rc = -5;
                break;
            }
            auto it = names->map.find(f1.tname);
            if (it == names->map.end()) {
                set_error("unexisting transcript '" + std::string(f1.tname) +
                          "' in the bowtie output file");
                rc = -3;
                break;
            }
            int mm = mm_from_mmstr(m1.data(), m1.size()) +
                     mm_from_mmstr(m2.data(), m2.size());
            char c1 = s1.empty() ? 0 : s1[0];
            char c2 = s2.empty() ? 0 : s2[0];
            int32_t fraglen, pos;
            bool ok;
            if (p2 > p1) {
                fraglen = p2 - p1 + (int32_t)readlength;
                pos = p1;
                ok = (strand_code != '-') && c1 == '+' && c2 == '-';
            } else {
                fraglen = p1 - p2 + (int32_t)readlength;
                pos = p2;
                ok = (strand_code != '+') && c1 == '-' && c2 == '+';
            }
            col.feed(pair_id, ok ? Aln{it->second, mm, fraglen, pos}
                                 : Aln{-1, 0, 0, 0});
        }
    }
    col.finish();
    *readlength_io = readlength;
    return rc;
}

}  // namespace

extern "C" {

const char* emsar_ingest_last_error() { return g_error.c_str(); }

void* emsar_make_name_table(const char* blob, const int64_t* offsets,
                            int64_t n) {
    auto* t = new NameTable();
    t->n = n;
    t->map.reserve((size_t)n * 2);
    for (int64_t i = 0; i < n; i++)
        t->map.emplace(std::string(blob + offsets[i],
                                   (size_t)(offsets[i + 1] - offsets[i])),
                       (int32_t)i);
    return t;
}

void emsar_free_name_table(void* t) { delete (NameTable*)t; }

void* emsar_make_sig_table(const int64_t* offsets, const int32_t* tids,
                           int64_t n) {
    auto* s = new SigTable();
    s->n = n;
    s->map.reserve((size_t)n * 2);
    for (int64_t i = 0; i < n; i++)
        s->map.emplace(
            std::string(reinterpret_cast<const char*>(tids + offsets[i]),
                        (size_t)(offsets[i + 1] - offsets[i]) * sizeof(int32_t)),
            i);
    return s;
}

void emsar_free_sig_table(void* s) { delete (SigTable*)s; }

// returns 0 on success; fills counts arrays.  readlength_io: in/out for PE
// (-1 = unknown).
int emsar_ingest_bowtie(const char* path, int pe, int strand_code,
                        int64_t max_repeat, int64_t min_frag,
                        int64_t max_frag, const void* name_table,
                        const void* sig_table, const uint8_t* has_single,
                        int64_t* single_counts, int64_t* multi_counts,
                        int64_t* fraglen_counts, int64_t hist_size,
                        int64_t* total_out, int64_t* readlength_io,
                        int nthreads, const int64_t* pb_tlen, int64_t pb_len,
                        double* pb_freq5, double* pb_freq3, double* pb_mark) {
    g_error.clear();
    const NameTable* names = (const NameTable*)name_table;
    const SigTable* sigs = (const SigTable*)sig_table;

    bool is_file = path && path[0];
    int64_t fsize = -1;
    if (is_file) {
        FILE* fh = fopen(path, "r");
        if (!fh) {
            set_error(std::string("can't open bowtie file ") + path);
            return -1;
        }
        fseeko(fh, 0, SEEK_END);
        fsize = (int64_t)ftello(fh);
        fclose(fh);
    }
    if (!is_file || nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if (fsize >= 0 && fsize < (int64_t)nthreads * (16 << 10)) nthreads = 1;

    if (nthreads == 1) {
        FILE* fh = is_file ? fopen(path, "r") : stdin;
        if (!fh) {
            set_error(std::string("can't open bowtie file ") + path);
            return -1;
        }
        Counts counts{single_counts, multi_counts, fraglen_counts, hist_size};
        counts.pb_tlen = pb_tlen;
        counts.pb_len = pb_len;
        counts.pb_freq5 = pb_freq5;
        counts.pb_freq3 = pb_freq3;
        counts.pb_mark = pb_mark;
        int rc = bowtie_worker(fh, -1, pe, strand_code, max_repeat, min_frag,
                               max_frag, names, sigs, has_single, counts,
                               readlength_io);
        if (fh != stdin) fclose(fh);
        *total_out = counts.total_read_count;
        return rc;
    }

    // Range-parallel: split the file at read-group boundaries; each worker
    // runs the full parse+collapse pipeline into private buffers which are
    // summed afterwards — counts are exactly those of the sequential run
    // (unlike the reference's racy -p mode, BASELINE_MEASURED.md).
    std::vector<int64_t> bounds(nthreads + 1);
    bounds[0] = 0;
    bounds[nthreads] = fsize;
    {
        FILE* fh = fopen(path, "r");
        if (!fh) {
            set_error(std::string("can't open bowtie file ") + path);
            return -1;
        }
        for (int t = 1; t < nthreads; t++) {
            int64_t from = fsize * t / nthreads;
            int64_t b = bowtie_group_boundary(fh, from, fsize, pe);
            bounds[t] = b < bounds[t - 1] ? bounds[t - 1] : b;
        }
        fclose(fh);
    }

    struct Priv {
        std::vector<int64_t> single, multi, hist;
        std::vector<double> pb5, pb3, pbm;
        Counts counts;
        int rc = 0;
        int64_t readlength;
    };
    std::vector<Priv> priv(nthreads);
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; t++) {
        Priv& p = priv[t];
        p.single.assign((size_t)names->n, 0);
        p.multi.assign((size_t)sigs->n, 0);
        p.hist.assign((size_t)hist_size, 0);
        p.counts = Counts{p.single.data(), p.multi.data(), p.hist.data(),
                          hist_size};
        if (pb_len) {
            p.pb5.assign((size_t)pb_len, 0.0);
            p.pb3.assign((size_t)pb_len, 0.0);
            p.pbm.assign((size_t)pb_len, 0.0);
            p.counts.pb_tlen = pb_tlen;
            p.counts.pb_len = pb_len;
            p.counts.pb_freq5 = p.pb5.data();
            p.counts.pb_freq3 = p.pb3.data();
            p.counts.pb_mark = p.pbm.data();
        }
        p.readlength = *readlength_io;
    }
    std::vector<std::string> errors(nthreads);
    for (int t = 0; t < nthreads; t++) {
        threads.emplace_back([&, t]() {
            Priv& p = priv[t];
            if (bounds[t] >= bounds[t + 1]) return;
            FILE* fh = fopen(path, "r");
            if (!fh) {
                p.rc = -1;
                errors[t] = std::string("can't open bowtie file ") + path;
                return;
            }
            fseeko(fh, (off_t)bounds[t], SEEK_SET);
            p.rc = bowtie_worker(fh, bounds[t + 1] - bounds[t], pe,
                                 strand_code, max_repeat, min_frag, max_frag,
                                 names, sigs, has_single, p.counts,
                                 &p.readlength);
            if (p.rc != 0) errors[t] = g_error;  // thread-local
            fclose(fh);
        });
    }
    for (auto& th : threads) th.join();

    int rc = 0;
    int64_t readlength = *readlength_io;
    for (int t = 0; t < nthreads; t++) {
        if (priv[t].rc != 0 && rc == 0) {
            rc = priv[t].rc;
            set_error(errors[t]);
        }
        if (priv[t].readlength != -1) {
            if (readlength == -1) readlength = priv[t].readlength;
            else if (readlength != priv[t].readlength && rc == 0) {
                set_error("paired-end data with variable read length is not "
                          "supported");
                rc = -5;
            }
        }
    }
    if (rc != 0) return rc;
    int64_t total = 0;
    for (int t = 0; t < nthreads; t++) {
        for (int64_t i = 0; i < names->n; i++)
            single_counts[i] += priv[t].single[i];
        for (int64_t i = 0; i < sigs->n; i++)
            multi_counts[i] += priv[t].multi[i];
        for (int64_t i = 0; i < hist_size; i++)
            fraglen_counts[i] += priv[t].hist[i];
        for (int64_t i = 0; i < pb_len; i++) {
            pb_freq5[i] += priv[t].pb5[(size_t)i];
            pb_freq3[i] += priv[t].pb3[(size_t)i];
            pb_mark[i] += priv[t].pbm[(size_t)i];
        }
        total += priv[t].counts.total_read_count;
    }
    *total_out = total;
    *readlength_io = readlength;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BAM (BGZF) / SAM
// ---------------------------------------------------------------------------

namespace {

// Read one raw BGZF block (compressed payload + isize) without inflating.
// Returns 1 = block read, 0 = clean EOF, -1 = error (g_error set).
int read_bgzf_block_raw(FILE* fh, std::vector<uint8_t>& cdata,
                        size_t* cdata_len, uint32_t* isize) {
    uint8_t hdr[12];
    size_t got = fread(hdr, 1, 12, fh);
    if (got == 0) return 0;
    if (got < 12 || hdr[0] != 0x1f || hdr[1] != 0x8b) {
        set_error("not a BGZF/gzip file");
        return -1;
    }
    uint16_t xlen = (uint16_t)(hdr[10] | (hdr[11] << 8));
    uint8_t extra[65536];
    if (fread(extra, 1, xlen, fh) != xlen) {
        set_error("truncated BGZF header");
        return -1;
    }
    int bsize = -1;
    for (size_t off = 0; off + 4 <= (size_t)xlen;) {
        uint8_t si1 = extra[off], si2 = extra[off + 1];
        uint16_t slen = (uint16_t)(extra[off + 2] | (extra[off + 3] << 8));
        if (si1 == 66 && si2 == 67 && slen == 2)
            bsize = extra[off + 4] | (extra[off + 5] << 8);
        off += 4 + slen;
    }
    if (bsize < 0) {
        set_error("missing BGZF BC subfield");
        return -1;
    }
    size_t clen = (size_t)bsize - xlen - 19;
    cdata.resize(clen + 8);
    if (fread(cdata.data(), 1, clen + 8, fh) != clen + 8) {
        set_error("truncated BGZF block");
        return -1;
    }
    *cdata_len = clen;
    *isize = (uint32_t)(cdata[clen + 4] | (cdata[clen + 5] << 8) |
                        (cdata[clen + 6] << 16) |
                        ((uint32_t)cdata[clen + 7] << 24));
    return 1;
}

// Inflate one raw BGZF payload into out[0..isize).  Thread-safe.
bool inflate_bgzf_block(const uint8_t* cdata, size_t cdata_len, uint8_t* out,
                        uint32_t isize) {
    if (isize == 0) return true;
    z_stream zs{};
    inflateInit2(&zs, -15);
    zs.next_in = const_cast<uint8_t*>(cdata);
    zs.avail_in = (uInt)cdata_len;
    zs.next_out = out;
    zs.avail_out = isize;
    int zrc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return zrc == Z_STREAM_END;
}

struct BgzfReader {
    FILE* fh;
    std::vector<uint8_t> out;   // decompressed buffer
    size_t pos = 0;
    bool eof = false;
    explicit BgzfReader(FILE* f) : fh(f) { out.reserve(1 << 17); }

    bool fill() {
        std::vector<uint8_t> cdata;
        size_t cdata_len;
        uint32_t isize;
        int rc = read_bgzf_block_raw(fh, cdata, &cdata_len, &isize);
        if (rc <= 0) {
            eof = true;
            return false;
        }
        size_t keep = out.size() - pos;
        if (pos > 0) {
            memmove(out.data(), out.data() + pos, keep);
            out.resize(keep);
            pos = 0;
        }
        size_t base = out.size();
        out.resize(base + isize);
        if (!inflate_bgzf_block(cdata.data(), cdata_len, out.data() + base,
                                isize)) {
            set_error("BGZF inflate failed");
            eof = true;
            return false;
        }
        return true;
    }

    // read exactly n bytes; returns pointer valid until next call
    const uint8_t* read(size_t n) {
        while (out.size() - pos < n) {
            if (!fill()) return nullptr;
        }
        const uint8_t* p = out.data() + pos;
        pos += n;
        return p;
    }
};

struct BamRec {
    std::string qname;
    int32_t ref_id, pos, l_seq;
    uint16_t flag;
    std::string md;
    bool has_md;
};

// Decode one BAM record body (p points after the 4-byte block_size).
void parse_bam_record(const uint8_t* p, int32_t block_size, BamRec* r) {
    int32_t ref_id, pos;
    memcpy(&ref_id, p, 4);
    memcpy(&pos, p + 4, 4);
    uint8_t l_read_name = p[8];
    uint16_t n_cigar = (uint16_t)(p[12] | (p[13] << 8));
    uint16_t flag = (uint16_t)(p[14] | (p[15] << 8));
    int32_t l_seq;
    memcpy(&l_seq, p + 16, 4);
    r->qname.assign((const char*)p + 32, (size_t)l_read_name - 1);
    r->ref_id = ref_id;
    r->pos = pos;
    r->flag = flag;
    r->l_seq = l_seq;
    size_t aux_off = 32 + l_read_name + 4 * (size_t)n_cigar +
                     ((size_t)l_seq + 1) / 2 + (size_t)l_seq;
    r->has_md = false;
    size_t off = aux_off;
    auto aux_size = [](uint8_t t) -> size_t {
        switch (t) {
            case 'A': case 'c': case 'C': return 1;
            case 's': case 'S': return 2;
            case 'i': case 'I': case 'f': return 4;
            default: return 0;
        }
    };
    while (off + 3 <= (size_t)block_size) {
        uint8_t t1 = p[off], t2 = p[off + 1], vt = p[off + 2];
        off += 3;
        if (vt == 'Z' || vt == 'H') {
            size_t z = off;
            while (z < (size_t)block_size && p[z]) z++;
            if (t1 == 'M' && t2 == 'D') {
                r->md.assign((const char*)p + off, z - off);
                r->has_md = true;
            }
            off = z + 1;
        } else if (vt == 'B') {
            uint8_t sub = p[off];
            int32_t count;
            memcpy(&count, p + off + 1, 4);
            off += 5 + aux_size(sub) * (size_t)count;
        } else {
            off += aux_size(vt);
        }
    }
}

struct BamReader {
    BgzfReader bgzf;
    std::vector<std::string> ref_names;
    std::vector<uint8_t> rec_buf;
    explicit BamReader(FILE* f) : bgzf(f) {}

    bool open_header() {
        const uint8_t* p = bgzf.read(4);
        if (!p || memcmp(p, "BAM\x01", 4) != 0) {
            set_error("not a BAM file (bad magic)");
            return false;
        }
        p = bgzf.read(4);
        if (!p) return false;
        int32_t l_text;
        memcpy(&l_text, p, 4);
        if (!bgzf.read((size_t)l_text)) return false;
        p = bgzf.read(4);
        if (!p) return false;
        int32_t n_ref;
        memcpy(&n_ref, p, 4);
        ref_names.reserve(n_ref);
        for (int32_t i = 0; i < n_ref; i++) {
            p = bgzf.read(4);
            if (!p) return false;
            int32_t l_name;
            memcpy(&l_name, p, 4);
            p = bgzf.read((size_t)l_name + 4);
            if (!p) return false;
            ref_names.emplace_back((const char*)p, (size_t)l_name - 1);
        }
        return true;
    }

    // 1 = got record, 0 = EOF, -1 = error
    int next(BamRec* r) {
        const uint8_t* p = bgzf.read(4);
        if (!p) return bgzf.eof && g_error.empty() ? 0 : (g_error.empty() ? 0 : -1);
        int32_t block_size;
        memcpy(&block_size, p, 4);
        p = bgzf.read((size_t)block_size);
        if (!p) {
            set_error("truncated BAM record");
            return -1;
        }
        parse_bam_record(p, block_size, r);
        return 1;
    }
};

// minimal SAM text record source with the same interface; byte-budgeted
// for range-parallel ingest (budget < 0 = unlimited)
struct SamReader {
    RangeLineReader rd;
    std::vector<std::string> dummy;
    NameTable const* names;  // unused; SAM carries names inline
    explicit SamReader(FILE* f, int64_t budget = -1)
        : rd(f, budget), names(nullptr) {}

    // 1 = record, 0 = EOF, -1 = error.  ref name returned via rname.
    int next(BamRec* r, std::string* rname) {
        char* line;
        ssize_t len;
        while ((len = rd.next(&line)) >= 0) {
            if (line[0] == '@') continue;
            // split into fields
            std::string_view f[12];
            int n = 0;
            char* start = line;
            char* p = line;
            for (;; p++) {
                if (*p == '\t' || *p == '\0') {
                    if (n < 12) f[n] = std::string_view(start, p - start);
                    n++;
                    if (*p == '\0' || n >= 12) break;
                    start = p + 1;
                }
            }
            if (n < 11) {
                set_error("malformed SAM line");
                return -1;
            }
            r->qname.assign(f[0]);
            r->flag = (uint16_t)parse_i32(f[1]);
            *rname = std::string(f[2]);
            r->ref_id = (*rname == "*") ? -1 : 0;
            r->pos = parse_i32(f[3]) - 1;
            r->l_seq = (f[9] == "*") ? 0 : (int32_t)f[9].size();
            r->has_md = false;
            // the remainder of the line may hold tags
            if (n >= 12) {
                // scan rest of line from f[11] onward (f[11] holds the first
                // tag; further tags still in the buffer after its end)
                const char* q = f[11].data();
                while (*q) {
                    const char* tab = strchr(q, '\t');
                    size_t tl = tab ? (size_t)(tab - q) : strlen(q);
                    if (tl > 5 && q[0] == 'M' && q[1] == 'D' && q[2] == ':' &&
                        q[3] == 'Z' && q[4] == ':') {
                        r->md.assign(q + 5, tl - 5);
                        r->has_md = true;
                    }
                    if (!tab) break;
                    q = tab + 1;
                }
            }
            return 1;
        }
        return 0;
    }
};

// rc -100: the record source ran out right after a mapped mate-1 record —
// only possible when a parallel split landed on a pairing-frame crossing
// (a qname group with an odd number of mapped records); the caller falls
// back to the exact sequential pass.
template <typename NextFn>
int ingest_records(NextFn&& next_rec, int pe, int strand_code,
                   Collapser& col, int64_t* readlength_io,
                   bool strict_tail = false) {
    BamRec r1, r2;
    int64_t readlength = *readlength_io;
    int rc;
    if (!pe) {
        while ((rc = next_rec(&r1)) == 1) {
            if (r1.ref_id < 0 || (r1.flag & 0x4)) continue;
            char strand = (r1.flag & 0x10) ? '-' : '+';
            if (strand_code != 0 && strand != (char)strand_code) continue;
            col.feed(r1.qname,
                     Aln{r1.ref_id, mm_from_md(r1.has_md ? r1.md.c_str()
                                                         : nullptr),
                         r1.l_seq, r1.pos});
        }
        return rc;
    }
    while ((rc = next_rec(&r1)) == 1) {
        if (r1.ref_id < 0 || (r1.flag & 0x4)) continue;
        int rc2 = next_rec(&r2);
        if (rc2 == 0) {
            if (strict_tail) return -100;
            break;
        }
        if (rc2 < 0) return rc2;
        if (r2.ref_id < 0 || (r2.flag & 0x4)) continue;  // skip broken pair
        if (readlength == -1) readlength = r1.l_seq;
        if (readlength != r1.l_seq || readlength != r2.l_seq) {
            set_error("paired-end data with variable read length is not "
                      "supported");
            return -5;
        }
        BamRec *b1, *b2;
        if ((r1.flag & 0x40) && (r2.flag & 0x80)) {
            b1 = &r1;
            b2 = &r2;
        } else if ((r2.flag & 0x40) && (r1.flag & 0x80)) {
            b1 = &r2;
            b2 = &r1;
        } else {
            set_error("mates are not grouped in the BAM/SAM file");
            return -6;
        }
        int mm = mm_from_md(b1->has_md ? b1->md.c_str() : nullptr) +
                 mm_from_md(b2->has_md ? b2->md.c_str() : nullptr);
        char s1 = (b1->flag & 0x10) ? '-' : '+';
        char s2 = (b2->flag & 0x10) ? '-' : '+';
        int32_t fraglen, pos;
        bool ok;
        if (b2->pos > b1->pos) {
            fraglen = b2->pos - b1->pos + (int32_t)readlength;
            pos = b1->pos;
            ok = (strand_code != '-') && s1 == '+' && s2 == '-';
        } else {
            fraglen = b1->pos - b2->pos + (int32_t)readlength;
            pos = b2->pos;
            ok = (strand_code != '+') && s1 == '-' && s2 == '+';
        }
        col.feed(r1.qname,
                 ok ? Aln{r1.ref_id, mm, fraglen, pos} : Aln{-1, 0, 0, 0});
    }
    *readlength_io = readlength;
    return rc;
}

// ---------------------------------------------------------------------------
// parallel BAM ingest: BGZF blocks inflate in parallel (they are
// independently deflated), a cheap serial walk finds record and
// qname-group boundaries in the decompressed stream, and group spans are
// parsed+collapsed by workers into private buffers (the same exact-merge
// discipline as the bowtie range split).  BAM records span BGZF blocks, so
// unlike text formats the *compressed* file cannot be range-split; the
// pipeline below parallelizes the two expensive stages instead.
// ---------------------------------------------------------------------------

struct IngestPriv {
    std::vector<int64_t> single, multi, hist;
    std::vector<double> pb5, pb3, pbm;
    Counts counts;
    int rc = 0;
    int64_t readlength = -1;
    std::string error;
};

struct PosArgs {
    const int64_t* tlen = nullptr;
    int64_t len = 0;
    double* freq5 = nullptr;
    double* freq3 = nullptr;
    double* mark = nullptr;
};

void init_privs(std::vector<IngestPriv>& priv, const NameTable* names,
                const SigTable* sigs, int64_t hist_size,
                int64_t readlength0, const PosArgs& pb) {
    for (auto& p : priv) {
        p.single.assign((size_t)names->n, 0);
        p.multi.assign((size_t)sigs->n, 0);
        p.hist.assign((size_t)hist_size, 0);
        p.counts = Counts{p.single.data(), p.multi.data(), p.hist.data(),
                          hist_size};
        if (pb.len) {
            p.pb5.assign((size_t)pb.len, 0.0);
            p.pb3.assign((size_t)pb.len, 0.0);
            p.pbm.assign((size_t)pb.len, 0.0);
            p.counts.pb_tlen = pb.tlen;
            p.counts.pb_len = pb.len;
            p.counts.pb_freq5 = p.pb5.data();
            p.counts.pb_freq3 = p.pb3.data();
            p.counts.pb_mark = p.pbm.data();
        }
        p.readlength = readlength0;
    }
}

// merge private buffers; returns first nonzero rc (readlength conflicts
// become rc -5)
int merge_privs(std::vector<IngestPriv>& priv, const NameTable* names,
                const SigTable* sigs, int64_t* single_counts,
                int64_t* multi_counts, int64_t* fraglen_counts,
                int64_t hist_size, int64_t* total_out,
                int64_t* readlength_io, const PosArgs& pb) {
    int rc = 0;
    int64_t readlength = *readlength_io;
    for (auto& p : priv) {
        if (p.rc != 0 && rc == 0) {
            rc = p.rc;
            set_error(p.error);
        }
        if (p.readlength != -1) {
            if (readlength == -1) readlength = p.readlength;
            else if (readlength != p.readlength && rc == 0) {
                set_error("paired-end data with variable read length is "
                          "not supported");
                rc = -5;
            }
        }
    }
    if (rc != 0) return rc;
    int64_t total = 0;
    for (auto& p : priv) {
        for (int64_t i = 0; i < names->n; i++) single_counts[i] += p.single[i];
        for (int64_t i = 0; i < sigs->n; i++) multi_counts[i] += p.multi[i];
        for (int64_t i = 0; i < hist_size; i++)
            fraglen_counts[i] += p.hist[i];
        for (int64_t i = 0; i < pb.len; i++) {
            pb.freq5[i] += p.pb5[(size_t)i];
            pb.freq3[i] += p.pb3[(size_t)i];
            pb.mark[i] += p.pbm[(size_t)i];
        }
        total += p.counts.total_read_count;
    }
    *total_out += total;
    *readlength_io = readlength;
    return 0;
}

// 0 ok, -100 = pairing frame crossed a split (caller reruns serially),
// other negatives = hard errors
int ingest_bam_parallel(FILE* fh, int pe, int strand_code,
                        int64_t max_repeat, int64_t min_frag,
                        int64_t max_frag, const NameTable* names,
                        const SigTable* sigs, const uint8_t* has_single,
                        int64_t* single_counts, int64_t* multi_counts,
                        int64_t* fraglen_counts, int64_t hist_size,
                        int64_t* total_out, int64_t* readlength_io,
                        int nthreads, const PosArgs& pb) {
    BamReader hdr_rd(fh);
    if (!hdr_rd.open_header()) return -7;
    // eager ref->tid map; unknown names only error when referenced
    std::vector<int32_t> ref2tid(hdr_rd.ref_names.size(), -3);
    for (size_t i = 0; i < hdr_rd.ref_names.size(); i++) {
        auto it = names->map.find(hdr_rd.ref_names[i]);
        if (it != names->map.end()) ref2tid[i] = it->second;
    }

    const int T = nthreads;
    std::vector<IngestPriv> priv(T);
    init_privs(priv, names, sigs, hist_size, *readlength_io, pb);

    // decompressed bytes already pulled while parsing the header
    std::vector<uint8_t> carry(hdr_rd.bgzf.out.begin() +
                                   (ptrdiff_t)hdr_rd.bgzf.pos,
                               hdr_rd.bgzf.out.end());

    const size_t SUPER = 48u << 20;  // decompressed bytes per super-chunk
    bool at_eof = false;
    std::vector<std::vector<uint8_t>> cdatas;
    std::vector<size_t> clens, ooffs;
    std::vector<uint32_t> isizes;
    std::vector<uint8_t> decomp;
    std::vector<size_t> grp_starts;

    while (true) {
        cdatas.clear();
        clens.clear();
        isizes.clear();
        ooffs.clear();
        size_t tot = 0;
        while (!at_eof && tot < SUPER) {
            std::vector<uint8_t> cd;
            size_t cl;
            uint32_t is;
            int r = read_bgzf_block_raw(fh, cd, &cl, &is);
            if (r < 0) return -7;
            if (r == 0) {
                at_eof = true;
                break;
            }
            ooffs.push_back(carry.size() + tot);
            tot += is;
            cdatas.push_back(std::move(cd));
            clens.push_back(cl);
            isizes.push_back(is);
        }
        if (tot == 0 && carry.empty()) break;  // fully drained
        decomp.resize(carry.size() + tot);
        if (!carry.empty()) memcpy(decomp.data(), carry.data(), carry.size());
        carry.clear();

        {  // parallel inflate
            std::atomic<size_t> next{0};
            std::atomic<bool> zerr{false};
            auto infl = [&]() {
                size_t i;
                while ((i = next.fetch_add(1)) < cdatas.size())
                    if (!inflate_bgzf_block(cdatas[i].data(), clens[i],
                                            decomp.data() + ooffs[i],
                                            isizes[i]))
                        zerr = true;
            };
            std::vector<std::thread> ths;
            for (int t = 1; t < T; t++) ths.emplace_back(infl);
            infl();
            for (auto& th : ths) th.join();
            if (zerr) {
                set_error("BGZF inflate failed");
                return -7;
            }
        }

        // serial record walk: record starts + qname-group starts
        grp_starts.clear();
        size_t off = 0, last_complete = 0;
        size_t prev_q = SIZE_MAX;
        uint8_t prev_qlen = 0;
        while (off + 4 <= decomp.size()) {
            uint32_t bs;
            memcpy(&bs, decomp.data() + off, 4);
            if (bs < 32 || off + 4 + (size_t)bs > decomp.size()) break;
            const uint8_t* p = decomp.data() + off + 4;
            uint8_t lrn = p[8];
            if (prev_q == SIZE_MAX || lrn != prev_qlen ||
                memcmp(decomp.data() + prev_q, p + 32, lrn) != 0)
                grp_starts.push_back(off);
            prev_q = off + 4 + 32;
            prev_qlen = lrn;
            off += 4 + bs;
            last_complete = off;
        }
        bool final = at_eof;
        size_t tail = decomp.size() - last_complete;
        if (final && tail > 0 && off + 4 <= decomp.size()) {
            // a record header claimed more bytes than remain
            set_error("truncated BAM record");
            return -7;
        }
        size_t n_groups = grp_starts.size();
        size_t n_proc;   // groups processed this chunk
        size_t proc_end;
        if (final) {
            if (tail > 0) {
                set_error("truncated BAM record");
                return -7;
            }
            n_proc = n_groups;
            proc_end = last_complete;
        } else if (n_groups <= 1) {
            // no complete group yet: keep accumulating
            carry.assign(decomp.begin(), decomp.end());
            continue;
        } else {
            n_proc = n_groups - 1;
            proc_end = grp_starts[n_proc];
        }

        if (n_proc > 0) {  // parallel parse+collapse over group spans
            std::vector<std::thread> ths;
            auto work = [&](int t) {
                size_t g0 = n_proc * (size_t)t / T;
                size_t g1 = n_proc * (size_t)(t + 1) / T;
                if (g0 >= g1) return;
                size_t cur = grp_starts[g0];
                size_t end = g1 < n_proc ? grp_starts[g1] : proc_end;
                IngestPriv& p = priv[t];
                if (p.rc != 0) return;
                Collapser col{sigs, has_single, min_frag, max_frag,
                              max_repeat, pe != 0, &p.counts};
                auto next = [&](BamRec* r) -> int {
                    if (cur >= end) return 0;
                    uint32_t bs;
                    memcpy(&bs, decomp.data() + cur, 4);
                    parse_bam_record(decomp.data() + cur + 4, (int32_t)bs, r);
                    cur += 4 + bs;
                    if (r->ref_id >= 0) {
                        int32_t tid = ref2tid[(size_t)r->ref_id];
                        if (tid == -3) {
                            p.error = "unexisting transcript '" +
                                      hdr_rd.ref_names[(size_t)r->ref_id] +
                                      "' in alignment file";
                            return -3;
                        }
                        r->ref_id = tid;
                    }
                    return 1;
                };
                // the very last span at true EOF keeps the sequential
                // dangling-record semantics; every other span end is a
                // parallel split and must not land mid-pair
                bool strict = !(final && g1 == n_proc);
                int rc = ingest_records(next, pe, strand_code, col,
                                        &p.readlength, strict);
                col.finish();
                if (rc < 0 && p.rc == 0) {
                    p.rc = rc;
                    if (p.error.empty()) p.error = g_error;
                }
            };
            for (int t = 1; t < T; t++) ths.emplace_back(work, t);
            work(0);
            for (auto& th : ths) th.join();
            for (auto& p : priv)
                if (p.rc != 0) {
                    if (p.rc != -100) set_error(p.error);
                    return p.rc;
                }
        }
        if (final) break;
        carry.assign(decomp.begin() + (ptrdiff_t)proc_end, decomp.end());
    }
    return merge_privs(priv, names, sigs, single_counts, multi_counts,
                       fraglen_counts, hist_size, total_out, readlength_io,
                       pb);
}

// first byte offset at or after `from` that starts a new qname group in a
// SAM text file
int64_t sam_group_boundary(FILE* fh, int64_t from, int64_t fsize) {
    if (from <= 0) return 0;
    fseeko(fh, (off_t)from, SEEK_SET);
    LineReader rd(fh);
    char* line;
    ssize_t len = rd.next(&line);
    if (len < 0) return fsize;
    int64_t off = from + len + 1;
    std::string prev_id;
    while (off < fsize) {
        len = rd.next(&line);
        if (len < 0) return fsize;
        if (line[0] != '@') {
            const char* tab = (const char*)memchr(line, '\t', (size_t)len);
            std::string_view id(line, tab ? (size_t)(tab - line)
                                          : (size_t)len);
            if (!prev_id.empty() && id != prev_id) return off;
            prev_id.assign(id.data(), id.size());
        }
        off += len + 1;
    }
    return fsize;
}

int ingest_sam_parallel(const char* path, int64_t fsize, int pe,
                        int strand_code, int64_t max_repeat, int64_t min_frag,
                        int64_t max_frag, const NameTable* names,
                        const SigTable* sigs, const uint8_t* has_single,
                        int64_t* single_counts, int64_t* multi_counts,
                        int64_t* fraglen_counts, int64_t hist_size,
                        int64_t* total_out, int64_t* readlength_io,
                        int nthreads, const PosArgs& pb) {
    const int T = nthreads;
    std::vector<int64_t> bounds((size_t)T + 1);
    bounds[0] = 0;
    bounds[(size_t)T] = fsize;
    {
        FILE* fh = fopen(path, "r");
        if (!fh) {
            set_error(std::string("can't open alignment file ") + path);
            return -1;
        }
        for (int t = 1; t < T; t++) {
            int64_t b = sam_group_boundary(fh, fsize * t / T, fsize);
            bounds[(size_t)t] = b < bounds[(size_t)t - 1]
                                    ? bounds[(size_t)t - 1] : b;
        }
        fclose(fh);
    }
    std::vector<IngestPriv> priv(T);
    init_privs(priv, names, sigs, hist_size, *readlength_io, pb);
    std::vector<std::thread> ths;
    auto work = [&](int t) {
        IngestPriv& p = priv[t];
        if (bounds[(size_t)t] >= bounds[(size_t)t + 1]) return;
        FILE* fh = fopen(path, "r");
        if (!fh) {
            p.rc = -1;
            p.error = std::string("can't open alignment file ") + path;
            return;
        }
        fseeko(fh, (off_t)bounds[(size_t)t], SEEK_SET);
        SamReader rd(fh, bounds[(size_t)t + 1] - bounds[(size_t)t]);
        Collapser col{sigs, has_single, min_frag, max_frag, max_repeat,
                      pe != 0, &p.counts};
        std::string rname;
        auto next = [&](BamRec* r) -> int {
            int res = rd.next(r, &rname);
            if (res == 1 && r->ref_id >= 0) {
                auto it = names->map.find(rname);
                if (it == names->map.end()) {
                    p.error = "unexisting transcript '" + rname +
                              "' in alignment file";
                    return -3;
                }
                r->ref_id = it->second;
            }
            return res;
        };
        bool strict = bounds[(size_t)t + 1] < fsize;
        p.rc = ingest_records(next, pe, strand_code, col, &p.readlength,
                              strict);
        col.finish();
        if (p.rc < 0 && p.error.empty()) p.error = g_error;
        fclose(fh);
    };
    for (int t = 1; t < T; t++) ths.emplace_back(work, t);
    work(0);
    for (auto& th : ths) th.join();
    for (auto& p : priv)
        if (p.rc == -100) return -100;
    return merge_privs(priv, names, sigs, single_counts, multi_counts,
                       fraglen_counts, hist_size, total_out, readlength_io,
                       pb);
}

}  // namespace

extern "C" int emsar_ingest_bam(
                     const char* path, int is_sam, int pe, int strand_code,
                     int64_t max_repeat, int64_t min_frag, int64_t max_frag,
                     const void* name_table, const void* sig_table,
                     const uint8_t* has_single, int64_t* single_counts,
                     int64_t* multi_counts, int64_t* fraglen_counts,
                     int64_t hist_size, int64_t* total_out,
                     int64_t* readlength_io, int nthreads,
                     const int64_t* pb_tlen, int64_t pb_len,
                     double* pb_freq5, double* pb_freq3, double* pb_mark) {
    g_error.clear();
    PosArgs pb{pb_tlen, pb_len, pb_freq5, pb_freq3, pb_mark};
    bool is_file = path && path[0];
    if (nthreads > 16) nthreads = 16;
    if (is_file && nthreads > 1) {
        const NameTable* names_p = (const NameTable*)name_table;
        const SigTable* sigs_p = (const SigTable*)sig_table;
        int rc;
        if (is_sam) {
            FILE* fh = fopen(path, "r");
            if (!fh) {
                set_error(std::string("can't open alignment file ") + path);
                return -1;
            }
            fseeko(fh, 0, SEEK_END);
            int64_t fsize = (int64_t)ftello(fh);
            fclose(fh);
            if (fsize < (int64_t)nthreads * (16 << 10))
                rc = -100;  // too small to split; run serially below
            else
                rc = ingest_sam_parallel(
                    path, fsize, pe, strand_code, max_repeat, min_frag,
                    max_frag, names_p, sigs_p, has_single, single_counts,
                    multi_counts, fraglen_counts, hist_size, total_out,
                    readlength_io, nthreads, pb);
        } else {
            FILE* fh = fopen(path, "rb");
            if (!fh) {
                set_error(std::string("can't open alignment file ") + path);
                return -1;
            }
            rc = ingest_bam_parallel(
                fh, pe, strand_code, max_repeat, min_frag,
                max_frag, names_p, sigs_p, has_single, single_counts,
                multi_counts, fraglen_counts, hist_size, total_out,
                readlength_io, nthreads, pb);
            fclose(fh);
        }
        if (rc != -100) return rc;
        // -100: a qname group with an odd number of mapped records crossed
        // a split point — rerun the exact sequential pass (output arrays
        // are untouched: workers merge only on success)
        g_error.clear();
    }
    FILE* fh = is_file ? fopen(path, "rb") : stdin;
    if (!fh) {
        set_error(std::string("can't open alignment file ") + path);
        return -1;
    }
    const NameTable* names = (const NameTable*)name_table;
    Collapser col{(const SigTable*)sig_table, has_single, min_frag, max_frag,
                  max_repeat, pe != 0, nullptr};
    Counts counts{single_counts, multi_counts, fraglen_counts, hist_size};
    counts.pb_tlen = pb_tlen;
    counts.pb_len = pb_len;
    counts.pb_freq5 = pb_freq5;
    counts.pb_freq3 = pb_freq3;
    counts.pb_mark = pb_mark;
    col.out = &counts;

    int rc;
    if (is_sam) {
        SamReader rd(fh);
        std::string rname;
        auto next = [&](BamRec* r) {
            int res = rd.next(r, &rname);
            if (res == 1 && r->ref_id >= 0) {
                auto it = names->map.find(rname);
                if (it == names->map.end()) {
                    set_error("unexisting transcript '" + rname +
                              "' in alignment file");
                    return -3;
                }
                r->ref_id = it->second;
            }
            return res;
        };
        rc = ingest_records(next, pe, strand_code, col, readlength_io);
    } else {
        BamReader rd(fh);
        if (!rd.open_header()) {
            if (fh != stdin) fclose(fh);
            return -7;
        }
        // map BAM ref ids -> our tids once
        std::vector<int32_t> ref2tid(rd.ref_names.size(), -2);
        auto next = [&](BamRec* r) {
            int res = rd.next(r);
            if (res == 1 && r->ref_id >= 0) {
                int32_t& t = ref2tid[(size_t)r->ref_id];
                if (t == -2) {
                    auto it = names->map.find(rd.ref_names[(size_t)r->ref_id]);
                    if (it == names->map.end()) {
                        set_error("unexisting transcript '" +
                                  rd.ref_names[(size_t)r->ref_id] +
                                  "' in alignment file");
                        t = -3;
                    } else {
                        t = it->second;
                    }
                }
                if (t == -3) return -3;
                r->ref_id = t;
            }
            return res;
        };
        rc = ingest_records(next, pe, strand_code, col, readlength_io);
    }
    col.finish();
    if (fh != stdin) fclose(fh);
    *total_out = counts.total_read_count;
    return rc < 0 ? rc : 0;
}


// ---------------------------------------------------------------------------
// hash grouping for index construction
//
// The device computes 128-bit window hashes (emsar_jax/index/kernels.py);
// grouping equal hashes is a hash-table problem, not a sort — this
// open-addressing table runs at ~50-100M rows/s on the host, replacing the
// O(N log^2 N) bitonic device sort for run detection.
// Outputs: perm = element indices ordered by group (groups contiguous,
// first-appearance order), run_id = group index per perm position.
// Returns the number of groups, or -1 on allocation failure.
// ---------------------------------------------------------------------------

extern "C" int64_t emsar_group_rows(const uint64_t* h1, const uint64_t* h2,
                                    const uint64_t* extra,  // may be null
                                    int64_t n, int64_t* perm,
                                    int64_t* run_id) {
    if (n == 0) return 0;
    // open addressing, power-of-two capacity >= 2n
    uint64_t cap = 1;
    while (cap < (uint64_t)n * 2) cap <<= 1;
    std::vector<int64_t> slot_group;
    std::vector<uint64_t> k1(cap), k2(cap), k3;
    std::vector<int64_t> head;
    slot_group.assign(cap, -1);
    if (extra) k3.assign(cap, 0);

    std::vector<int64_t> group_of((size_t)n);
    std::vector<int64_t> group_count;
    group_count.reserve((size_t)n / 4 + 16);

    const uint64_t mask = cap - 1;
    for (int64_t i = 0; i < n; i++) {
        uint64_t a = h1[i], b = h2[i];
        uint64_t c = extra ? extra[i] : 0;
        // mix the key triple into a probe start
        uint64_t h = a ^ (b * 0x9E3779B97F4A7C15ULL) ^
                     (c * 0xC2B2AE3D27D4EB4FULL);
        h ^= h >> 29;
        uint64_t s = h & mask;
        while (true) {
            int64_t g = slot_group[s];
            if (g == -1) {
                int64_t gid = (int64_t)group_count.size();
                slot_group[s] = gid;
                k1[s] = a;
                k2[s] = b;
                if (extra) k3[s] = c;
                group_count.push_back(1);
                group_of[i] = gid;
                break;
            }
            if (k1[s] == a && k2[s] == b && (!extra || k3[s] == c)) {
                group_of[i] = g;
                group_count[g]++;
                break;
            }
            s = (s + 1) & mask;
        }
    }

    // counting sort into perm (stable: first-appearance group order)
    int64_t n_groups = (int64_t)group_count.size();
    std::vector<int64_t> offsets((size_t)n_groups + 1);
    offsets[0] = 0;
    for (int64_t g = 0; g < n_groups; g++)
        offsets[(size_t)g + 1] = offsets[(size_t)g] + group_count[(size_t)g];
    std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
    for (int64_t i = 0; i < n; i++) {
        int64_t g = group_of[(size_t)i];
        int64_t at = cursor[(size_t)g]++;
        perm[at] = i;
        run_id[at] = g;
    }
    return n_groups;
}
