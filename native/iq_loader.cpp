// fc32 IQ capture loader: the native data-loader at the sample-I/O boundary
// (the role UHD's C++ driver plays for the reference — SURVEY.md L1).
//
// mmaps .dat capture files (interleaved little-endian f32 I/Q, the wire
// format of /root/reference/src/utils.rs:228-254 and UHD's
// rx_samples_to_file) and deinterleaves chunks into planar float32 re/im
// buffers — the planar layout core/transfer.py uploads, so the Python
// layer never touches the samples.  C ABI for ctypes.

#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Capture {
    const float* data;   // interleaved I/Q
    size_t n_samples;
    size_t map_len;
    int fd;
};

}  // namespace

extern "C" {

// Open a capture; returns an opaque handle (nullptr on failure).
void* iq_open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 8) {
        ::close(fd);
        return nullptr;
    }
    size_t len = static_cast<size_t>(st.st_size);
    void* map = mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
    if (map == MAP_FAILED) {
        ::close(fd);
        return nullptr;
    }
    madvise(map, len, MADV_SEQUENTIAL);
    auto* c = new Capture{static_cast<const float*>(map),
                          len / 8, len, fd};
    return c;
}

int64_t iq_n_samples(void* handle) {
    return handle ? static_cast<Capture*>(handle)->n_samples : -1;
}

// Deinterleave samples [start, start+count) into planar re/im float buffers.
// Returns the number of samples written (clipped at EOF).
int64_t iq_read_planar(void* handle, int64_t start, int64_t count,
                       float* re, float* im) {
    if (!handle || start < 0) return -1;
    auto* c = static_cast<Capture*>(handle);
    if (static_cast<size_t>(start) >= c->n_samples) return 0;
    size_t n = count;
    if (start + n > c->n_samples) n = c->n_samples - start;
    const float* p = c->data + 2 * start;
    for (size_t i = 0; i < n; ++i) {
        re[i] = p[2 * i];
        im[i] = p[2 * i + 1];
    }
    return static_cast<int64_t>(n);
}

void iq_close(void* handle) {
    if (!handle) return;
    auto* c = static_cast<Capture*>(handle);
    munmap(const_cast<float*>(c->data), c->map_len);
    ::close(c->fd);
    delete c;
}

}  // extern "C"
