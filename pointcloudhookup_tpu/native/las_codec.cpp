// Native LAS point codec: the host-side decode feeding the device.
//
// The reference delegates LAS I/O to laspy (Python); at 50M+ point
// corridors (BASELINE config 5) the host decode sits on the critical
// path opposite device compute, so this implements the inner loop --
// strided int32 triplet decode + scale/offset -- in C++ with no Python
// object overhead.  Exposed via ctypes (pointcloudhookup_tpu/native/
// __init__.py builds it on first use and falls back to numpy).
//
// Layout knowledge mirrors io/las.py (LAS 1.2-1.4, point formats 0-8).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

namespace {

struct Header {
    uint16_t header_size;
    uint32_t point_offset;
    uint8_t point_format;
    uint16_t record_len;
    uint64_t count;
    double scale[3];
    double offset[3];
};

bool read_header(FILE* f, Header* h) {
    unsigned char buf[375];
    if (fread(buf, 1, 227, f) != 227) return false;
    if (memcmp(buf, "LASF", 4) != 0) return false;
    uint8_t ver_minor = buf[25];
    memcpy(&h->header_size, buf + 94, 2);
    memcpy(&h->point_offset, buf + 96, 4);
    uint8_t fmt_raw = buf[104];
    if (fmt_raw & 0x80) return false;  // LAZ unsupported
    h->point_format = fmt_raw & 0x3F;
    memcpy(&h->record_len, buf + 105, 2);
    uint32_t legacy;
    memcpy(&legacy, buf + 107, 4);
    h->count = legacy;
    memcpy(h->scale, buf + 131, 24);
    memcpy(h->offset, buf + 155, 24);
    if (ver_minor >= 4) {
        if (fread(buf + 227, 1, 375 - 227, f) != (size_t)(375 - 227)) return false;
        uint64_t count64;
        memcpy(&count64, buf + 247, 8);
        if (count64) h->count = count64;
    }
    return true;
}

}  // namespace

extern "C" {

// Returns point count, or -1 on failure.  scales/offsets: double[3] out.
long long las_probe(const char* path, double* scales, double* offsets,
                    int* point_format) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    Header h;
    bool ok = read_header(f, &h);
    fclose(f);
    if (!ok) return -1;
    memcpy(scales, h.scale, 24);
    memcpy(offsets, h.offset, 24);
    *point_format = h.point_format;
    return (long long)h.count;
}

// Decode world-coordinate xyz into out[count*3] (f64).  Returns the
// number of points decoded, or -1 on failure.
long long las_read_xyz(const char* path, double* out, long long capacity) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    Header h;
    if (!read_header(f, &h)) { fclose(f); return -1; }
    long long n = (long long)h.count;
    if (n > capacity) n = capacity;
    if (fseek(f, (long)h.point_offset, SEEK_SET) != 0) { fclose(f); return -1; }

    const size_t rec = h.record_len;
    const size_t CHUNK = 1 << 16;
    unsigned char* buf = (unsigned char*)malloc(CHUNK * rec);
    if (!buf) { fclose(f); return -1; }
    const double sx = h.scale[0], sy = h.scale[1], sz = h.scale[2];
    const double ox = h.offset[0], oy = h.offset[1], oz = h.offset[2];
    long long done = 0;
    while (done < n) {
        size_t want = (size_t)((n - done) < (long long)CHUNK ? (n - done) : CHUNK);
        size_t got = fread(buf, rec, want, f);
        if (got == 0) break;
        for (size_t i = 0; i < got; ++i) {
            int32_t xyz[3];
            memcpy(xyz, buf + i * rec, 12);
            double* o = out + (done + (long long)i) * 3;
            o[0] = xyz[0] * sx + ox;
            o[1] = xyz[1] * sy + oy;
            o[2] = xyz[2] * sz + oz;
        }
        done += (long long)got;
    }
    free(buf);
    fclose(f);
    return done;
}

// Decode a [start, start+count) range (for tile streaming).
long long las_read_xyz_range(const char* path, double* out,
                             long long start, long long count) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    Header h;
    if (!read_header(f, &h)) { fclose(f); return -1; }
    long long n = (long long)h.count;
    if (start >= n) { fclose(f); return 0; }
    if (start + count > n) count = n - start;
    const size_t rec = h.record_len;
    if (fseek(f, (long)(h.point_offset + (unsigned long long)start * rec),
              SEEK_SET) != 0) { fclose(f); return -1; }
    unsigned char* buf = (unsigned char*)malloc((size_t)count * rec);
    if (!buf) { fclose(f); return -1; }
    size_t got = fread(buf, rec, (size_t)count, f);
    const double sx = h.scale[0], sy = h.scale[1], sz = h.scale[2];
    const double ox = h.offset[0], oy = h.offset[1], oz = h.offset[2];
    for (size_t i = 0; i < got; ++i) {
        int32_t xyz[3];
        memcpy(xyz, buf + i * rec, 12);
        double* o = out + (long long)i * 3;
        o[0] = xyz[0] * sx + ox;
        o[1] = xyz[1] * sy + oy;
        o[2] = xyz[2] * sz + oz;
    }
    free(buf);
    fclose(f);
    return (long long)got;
}

}  // extern "C"
