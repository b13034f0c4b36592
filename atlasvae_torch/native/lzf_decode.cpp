// LZF decompression (liblzf's format, as h5py's lzf filter writes chunks).
//
// A stream is a run of tokens.  A control byte below 32 starts a literal run
// of (ctrl + 1) bytes that follow it.  Any other control byte is a
// back-reference: its length is (ctrl >> 5) + 2, where a length field of 7
// is extended by the next byte; its offset behind the output position is
// ((ctrl & 31) << 8) + the byte after that + 1.  A back-reference that
// overlaps the bytes it writes is copied byte by byte; literal runs and the
// other back-references with memcpy.
//
// Built at first use by atlasvae_torch/native (g++ -O2 -shared -fPIC) and
// called from atlasvae_torch/data/lzf.py over ctypes; lzf.py's
// decompress_plain is the same decoder in Python, and the tests hold the two
// to each other byte for byte.

#include <cstdint>
#include <cstring>

extern "C" {

// Decompress in[0:n_in] into out[0:out_cap].  Returns the number of bytes
// written, or -1 when the output would pass out_cap, -2 when a token reaches
// past the input, -3 when a back-reference points before the output.
long long lzf_decompress(const unsigned char* in, long long n_in,
                         unsigned char* out, long long out_cap) {
    const unsigned char* ip = in;
    const unsigned char* const in_end = in + n_in;
    long long op = 0;
    while (ip < in_end) {
        unsigned int ctrl = *ip++;
        if (ctrl < 32) {
            long long len = (long long)ctrl + 1;
            if (op + len > out_cap) return -1;
            if (ip + len > in_end) return -2;
            std::memcpy(out + op, ip, (size_t)len);
            op += len;
            ip += len;
            continue;
        }
        long long len = ctrl >> 5;
        if (len == 7) {
            if (ip >= in_end) return -2;
            len += *ip++;
        }
        if (ip >= in_end) return -2;
        long long back = ((long long)(ctrl & 31) << 8) + *ip++ + 1;
        len += 2;
        if (back > op) return -3;
        if (op + len > out_cap) return -1;
        const unsigned char* ref = out + op - back;
        unsigned char* dst = out + op;
        if (back >= len) {
            std::memcpy(dst, ref, (size_t)len);
        } else {
            for (long long i = 0; i < len; ++i) dst[i] = ref[i];
        }
        op += len;
    }
    return op;
}

}  // extern "C"
