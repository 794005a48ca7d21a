// Native host data plane of the PyTorch port: interaction and KG file
// parsing, first-appearance id factorisation and the (major, minor) edge
// sort of adjacency construction.
//
// The port's own copy of the JAX package's native/fastload.cpp. Its
// interaction parser reads any number of leading integer columns, so one
// entry point serves the two-column interaction files and the three-column
// KG triple files; the blocked-COO packer is not part of this copy (the
// port's packer derives per-row slot ranges from its own slot map).
// Exposed through a plain C ABI consumed via ctypes (native/__init__.py).
//
// Build: g++ -O3 -shared -fPIC fastload.cpp -o libfastload.so

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Parse a file whose first line is a header (skipped), then one record per
// line: `ncols` integers separated by tabs, commas or spaces, anything after
// them ignored (the reference's loader keeps the first columns; the weight
// is forced to 1.0). A line without `ncols` integers is skipped.
// Returns the record count and fills *out with a malloc'd row-major int64
// [n, ncols] array the caller releases with hd_free; -1 on an I/O error.
int64_t hd_load_columns(const char* path, int64_t ncols, int64_t** out) {
    *out = nullptr;
    if (ncols <= 0 || ncols > 16) return -1;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    size_t len = (size_t)st.st_size;
    if (len == 0) { close(fd); return 0; }
    const char* data = (const char*)mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (data == MAP_FAILED) return -1;

    // upper bound on records = newline count + 1
    size_t cap = 1;
    for (size_t i = 0; i < len; ++i) cap += (data[i] == '\n');
    int64_t* v = (int64_t*)malloc(cap * (size_t)ncols * sizeof(int64_t));
    if (!v) { munmap((void*)data, len); return -1; }

    size_t pos = 0;
    // skip the header line
    while (pos < len && data[pos] != '\n') ++pos;
    if (pos < len) ++pos;

    int64_t n = 0;
    int64_t rec[16];
    while (pos < len) {
        int64_t got = 0;
        while (got < ncols) {
            while (pos < len && (data[pos] == ' ' || data[pos] == '\t' || data[pos] == ','))
                ++pos;
            if (pos >= len || data[pos] == '\n' || data[pos] == '\r') break;
            bool neg = data[pos] == '-';
            if (neg) ++pos;
            int64_t a = 0;
            bool digits = false;
            while (pos < len && data[pos] >= '0' && data[pos] <= '9') {
                a = a * 10 + (data[pos] - '0');
                ++pos;
                digits = true;
            }
            if (!digits) break;
            rec[got++] = neg ? -a : a;
        }
        // skip the rest of the line
        while (pos < len && data[pos] != '\n') ++pos;
        if (pos < len) ++pos;
        if (got == ncols) {
            memcpy(v + n * ncols, rec, (size_t)ncols * sizeof(int64_t));
            ++n;
        }
    }
    munmap((void*)data, len);
    *out = v;
    return n;
}

// First-appearance factorize (pandas.factorize semantics, the id-map
// order the reference's dict inserts produce, ui_graph.py:43-52).
// codes: out int32[n]; uniques: out int64[n] (first n_unique filled).
// Returns n_unique, or -1 when out of memory.
int64_t hd_factorize(const int64_t* vals, int64_t n, int32_t* codes, int64_t* uniques) {
    if (n <= 0) return 0;
    // open addressing, power-of-two capacity >= 2n
    size_t cap = 16;
    while (cap < (size_t)(2 * n)) cap <<= 1;
    int64_t* keys = (int64_t*)malloc(cap * sizeof(int64_t));
    int32_t* slot_code = (int32_t*)malloc(cap * sizeof(int32_t));
    if (!keys || !slot_code) { free(keys); free(slot_code); return -1; }
    memset(slot_code, 0xFF, cap * sizeof(int32_t));  // -1 = empty

    int64_t n_unique = 0;
    const uint64_t mask = cap - 1;
    for (int64_t i = 0; i < n; ++i) {
        int64_t k = vals[i];
        uint64_t s = ((uint64_t)k * 0x9E3779B97F4A7C15ull) & mask;
        while (true) {
            if (slot_code[s] == -1) {
                keys[s] = k;
                slot_code[s] = (int32_t)n_unique;
                uniques[n_unique] = k;
                codes[i] = (int32_t)n_unique;
                ++n_unique;
                break;
            }
            if (keys[s] == k) { codes[i] = slot_code[s]; break; }
            s = (s + 1) & mask;
        }
    }
    free(keys);
    free(slot_code);
    return n_unique;
}

// Stable argsort of (major, minor) int64 key pairs: np.lexsort((minor,
// major)). LSD radix over 16-bit digits, the passes on minor first, then
// the stable passes on major; digits above a key's maximum are skipped.
// Keys must be non-negative (graph ids). perm: out int64[n].
// Returns 0, -1 when out of memory, -2 on a negative key.
int64_t hd_sort_pairs(const int64_t* major, const int64_t* minor, int64_t n, int64_t* perm) {
    if (n <= 0) return 0;
    int64_t max_major = 0, max_minor = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (major[i] < 0 || minor[i] < 0) return -2;
        if (major[i] > max_major) max_major = major[i];
        if (minor[i] > max_minor) max_minor = minor[i];
    }
    int64_t* cur = perm;
    int64_t* alt = (int64_t*)malloc(n * sizeof(int64_t));
    int64_t* counts = (int64_t*)malloc(65536 * sizeof(int64_t));
    if (!alt || !counts) { free(alt); free(counts); return -1; }
    for (int64_t i = 0; i < n; ++i) cur[i] = i;

    const int64_t* keysets[2] = {minor, major};
    const int64_t maxes[2] = {max_minor, max_major};
    for (int k = 0; k < 2; ++k) {
        const int64_t* key = keysets[k];
        for (int shift = 0; shift < 64; shift += 16) {
            if ((maxes[k] >> shift) == 0 && shift > 0) break;
            memset(counts, 0, 65536 * sizeof(int64_t));
            for (int64_t i = 0; i < n; ++i) ++counts[(key[cur[i]] >> shift) & 0xFFFF];
            int64_t run = 0;
            for (int d = 0; d < 65536; ++d) {
                int64_t c = counts[d];
                counts[d] = run;
                run += c;
            }
            for (int64_t i = 0; i < n; ++i) alt[counts[(key[cur[i]] >> shift) & 0xFFFF]++] = cur[i];
            int64_t* tmp = cur;
            cur = alt;
            alt = tmp;
        }
    }
    if (cur != perm) memcpy(perm, cur, n * sizeof(int64_t));
    free(cur == perm ? alt : cur);
    free(counts);
    return 0;
}

void hd_free(void* p) { free(p); }

}  // extern "C"
