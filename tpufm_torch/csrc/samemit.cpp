// SAM record emitter of the port's aligner: the host loop that formats
// tpufm_torch/host/sam.py's ``sam_single_records`` (a copy of tpufm's
// native/samemit.cpp). It takes the arrays sam.py prepares in vectorized
// passes (per-site ok/nm/record/pos, the batch-decoded ASCII) and writes
// the same record lines as sam.py's Python loop, which is its plain
// version: tests/test_torch_sam.py holds the two equal. Built with the host
// C++ compiler into tpufm_torch/_build/ at first use and loaded through
// ctypes (a plain C interface); a failed build raises.

#include <cstdint>
#include <cstring>

namespace {

// minimal unsigned itoa; returns chars written
inline int put_u64(char* dst, uint64_t v) {
    char tmp[20];
    int n = 0;
    do {
        tmp[n++] = char('0' + v % 10);
        v /= 10;
    } while (v);
    for (int i = 0; i < n; ++i) dst[i] = tmp[n - 1 - i];
    return n;
}

inline int put_i64(char* dst, int64_t v) {
    if (v < 0) {
        dst[0] = '-';
        return 1 + put_u64(dst + 1, uint64_t(-v));
    }
    return put_u64(dst, uint64_t(v));
}

struct Site {
    int64_t nm;
    int32_t order;
    int32_t flag;
    int32_t cname;
    int64_t pos1;
};

}  // namespace

extern "C" {

// Emit one block of SAM record lines per read (newline-terminated
// records, blocks concatenated; block_ends[i] = byte offset one past
// read i's last record). Returns total bytes written, or -1 if out_cap
// would overflow (sam.py sizes the buffer so that it cannot, and raises
// if it does).
//
// Layout contracts (match sam.py's vectorized precomputation):
//   fwd_ascii / rc_ascii: char[B * Lmax]; read i's forward SEQ is
//     fwd_ascii[i*Lmax + Lmax - L .. i*Lmax + Lmax), its rc SEQ is
//     rc_ascii[i*Lmax .. i*Lmax + L) with L = Ls[i].
//   names_buf/names_off: concatenated QNAMEs, names_off[B+1].
//   quals_buf/quals_off: concatenated per-read Phred+33 strings in
//     sequenced orientation (empty string -> '*'); pass quals_off = NULL
//     for no qualities anywhere. Minus-strand records reverse the QUAL.
//   ok_*/nm_*/idx_*/p1_*: int8/int64/int32/int64 [B*H] per-site arrays
//     (idx indexes cnames_buf/cnames_off, ncontig entries).
int64_t tpufm_sam_emit_single(
    int64_t B, int64_t H, int64_t Lmax, const int64_t* Ls,
    const char* fwd_ascii, const char* rc_ascii,
    const char* names_buf, const int64_t* names_off,
    const char* quals_buf, const int64_t* quals_off,
    const char* cnames_buf, const int64_t* cnames_off,
    const int8_t* ok_f, const int64_t* nm_f, const int32_t* idx_f,
    const int64_t* p1_f,
    const int8_t* ok_r, const int64_t* nm_r, const int32_t* idx_r,
    const int64_t* p1_r,
    char* out, int64_t out_cap, int64_t* block_ends) {
    char* w = out;
    char* end = out + out_cap;
    Site sites[512];
    const int64_t maxsites = int64_t(sizeof(sites) / sizeof(sites[0]));
    for (int64_t i = 0; i < B; ++i) {
        const int64_t L = Ls[i];
        const char* seq_f = fwd_ascii + i * Lmax + (Lmax - L);
        const char* seq_r = rc_ascii + i * Lmax;
        const char* name = names_buf + names_off[i];
        const int64_t name_len = names_off[i + 1] - names_off[i];
        const char* qual = quals_off ? quals_buf + quals_off[i] : nullptr;
        const int64_t qual_len = quals_off
            ? quals_off[i + 1] - quals_off[i] : 0;
        int64_t ns = 0;
        for (int pass = 0; pass < 2; ++pass) {
            const int8_t* ok = pass ? ok_r : ok_f;
            const int64_t* nm = pass ? nm_r : nm_f;
            const int32_t* idx = pass ? idx_r : idx_f;
            const int64_t* p1 = pass ? p1_r : p1_f;
            for (int64_t j = 0; j < H && ns < maxsites; ++j) {
                const int64_t o = i * H + j;
                if (ok[o]) {
                    sites[ns] = {nm[o], int32_t(ns), pass ? 16 : 0,
                                 idx[o], p1[o]};
                    ++ns;
                }
            }
        }
        // stable insertion sort by (nm, order) — site lists are tiny
        for (int64_t a = 1; a < ns; ++a) {
            Site key = sites[a];
            int64_t b = a - 1;
            while (b >= 0 && (sites[b].nm > key.nm ||
                              (sites[b].nm == key.nm &&
                               sites[b].order > key.order))) {
                sites[b + 1] = sites[b];
                --b;
            }
            sites[b + 1] = key;
        }
        int mapq = 0;
        if (ns) {
            int ties = 1;
            for (int64_t a = 1; a < ns && sites[a].nm == sites[0].nm; ++a)
                ++ties;
            mapq = ties == 1 ? 60 : 0;
        }
        if (ns == 0) {
            if (w + name_len + L + qual_len + 64 > end) return -1;
            std::memcpy(w, name, name_len); w += name_len;
            std::memcpy(w, "\t4\t*\t0\t0\t*\t*\t0\t0\t", 17); w += 17;
            std::memcpy(w, seq_f, L); w += L;
            *w++ = '\t';
            if (qual_len) { std::memcpy(w, qual, qual_len); w += qual_len; }
            else *w++ = '*';
            *w++ = '\n';
        }
        for (int64_t a = 0; a < ns; ++a) {
            const Site& s = sites[a];
            const int64_t cn = cnames_off[s.cname + 1] - cnames_off[s.cname];
            if (w + name_len + cn + L + qual_len + 96 > end) return -1;
            const int flag = s.flag | (a ? 0x100 : 0);
            std::memcpy(w, name, name_len); w += name_len;
            *w++ = '\t';
            w += put_u64(w, uint64_t(flag));
            *w++ = '\t';
            std::memcpy(w, cnames_buf + cnames_off[s.cname], cn); w += cn;
            *w++ = '\t';
            w += put_i64(w, s.pos1);
            *w++ = '\t';
            w += put_u64(w, uint64_t(mapq));
            *w++ = '\t';
            w += put_u64(w, uint64_t(L));
            *w++ = 'M';
            std::memcpy(w, "\t*\t0\t0\t", 7); w += 7;
            std::memcpy(w, s.flag ? seq_r : seq_f, L); w += L;
            *w++ = '\t';
            if (qual_len) {
                if (s.flag) {  // minus strand: reversed QUAL
                    for (int64_t q = qual_len - 1; q >= 0; --q)
                        *w++ = qual[q];
                } else {
                    std::memcpy(w, qual, qual_len); w += qual_len;
                }
            } else {
                *w++ = '*';
            }
            std::memcpy(w, "\tNM:i:", 6); w += 6;
            w += put_i64(w, s.nm);
            *w++ = '\n';
        }
        block_ends[i] = w - out;
    }
    return w - out;
}

}  // extern "C"
