// unicore_tpu_torch native host runtime: fast FASTA scanning + k-mer bag
// featurization for the prefilter (the port's copy of
// unicore_tpu/native/fastio.cpp).  The device does the heavy compute; this
// library keeps the host-side data path (parsing millions of residues,
// building feature bags) off the Python interpreter, mirroring the role
// native code plays in the reference's delegated engines.
//
// Exposed C ABI (loaded via ctypes, see native/__init__.py):
//   ufio_count_fasta(path)                      -> number of records (-1 err)
//   ufio_read_fasta(path, cb, ctx)              -> streams (header, seq)
//   ufio_featurize(codes*, lens*, n, k, dim, channel, out*)
//       codes: concatenated int8 sequence codes; out: n x dim float32
//       binary hashed k-mer bags (matches prefilter._kmer_hashes)
//   ufio_version()

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

typedef void (*fasta_cb)(const char *header, long hlen, const char *seq,
                         long slen, void *ctx);

int ufio_version() { return 1; }

long ufio_count_fasta(const char *path) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  long count = 0;
  int c, prev = '\n';
  while ((c = fgetc(f)) != EOF) {
    if (c == '>' && prev == '\n') count++;
    prev = c;
  }
  fclose(f);
  return count;
}

int ufio_read_fasta(const char *path, fasta_cb cb, void *ctx) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(size);
  if (size > 0 && fread(&buf[0], 1, size, f) != (size_t)size) {
    fclose(f);
    return -2;
  }
  fclose(f);

  std::string header, seq;
  bool have = false;
  size_t i = 0;
  while (i < buf.size()) {
    size_t eol = buf.find('\n', i);
    if (eol == std::string::npos) eol = buf.size();
    size_t len = eol - i;
    // strip trailing CR
    while (len > 0 && (buf[i + len - 1] == '\r' || buf[i + len - 1] == ' '))
      len--;
    if (len > 0 && buf[i] == '>') {
      if (have) cb(header.data(), header.size(), seq.data(), seq.size(), ctx);
      header.assign(buf, i + 1, len - 1);
      seq.clear();
      have = true;
    } else if (len > 0) {
      size_t s = i, e = i + len;
      while (s < e && (buf[s] == ' ' || buf[s] == '\t')) s++;
      while (e > s && (buf[e - 1] == ' ' || buf[e - 1] == '\t')) e--;
      seq.append(buf, s, e - s);
    }
    i = eol + 1;
  }
  if (have) cb(header.data(), header.size(), seq.data(), seq.size(), ctx);
  return 0;
}

// Feature hashing identical to align/prefilter.py::_kmer_hashes:
//   v = sum codes[i+j] * 21^(k-1-j);  h = (v + channel*0x1000003) *
//   0x9E3779B97F4A7C15;  h ^= h >> 29;  bucket = h % dim
static void featurize_range(const int8_t *codes, const int64_t *offsets,
                            const int32_t *lens, int k, int dim, int channel,
                            float *out, long lo, long hi) {
  const uint64_t MULT = 0x9E3779B97F4A7C15ULL;
  for (long s = lo; s < hi; s++) {
    const int8_t *c = codes + offsets[s];
    int n = lens[s] - k + 1;
    float *row = out + (long)s * dim;
    for (int i = 0; i < n; i++) {
      uint64_t v = 0;
      for (int j = 0; j < k; j++) v = v * 21ULL + (uint64_t)(uint8_t)c[i + j];
      uint64_t h = (v + (uint64_t)channel * 0x1000003ULL) * MULT;
      h ^= h >> 29;
      row[h % (uint64_t)dim] = 1.0f;
    }
  }
}

int ufio_featurize(const int8_t *codes, const int64_t *offsets,
                   const int32_t *lens, long nseq, int k, int dim,
                   int channel, float *out, int nthreads) {
  if (nthreads <= 1 || nseq < 64) {
    featurize_range(codes, offsets, lens, k, dim, channel, out, 0, nseq);
    return 0;
  }
  std::vector<std::thread> threads;
  long chunk = (nseq + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    long lo = t * chunk, hi = std::min(nseq, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(featurize_range, codes, offsets, lens, k, dim,
                         channel, out, lo, hi);
  }
  for (auto &th : threads) th.join();
  return 0;
}

}  // extern "C"
