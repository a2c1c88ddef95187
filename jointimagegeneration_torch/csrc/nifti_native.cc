// The port's native data route: NIfTI-1 read and write, CT windowing, the
// TotalSegmentator label remap and the one-hot, over a plain C interface
// that `data/native.py` binds with ctypes (which releases the GIL for each
// call, so the loader's threads decode in parallel).
//
// Each function returns, bit for bit, what its plain numpy version returns:
//
//   jig_open_nifti / jig_read_voxels   data/nifti.read_nifti: the stored
//       dtype in the machine's byte order, float32 only when scl_slope /
//       scl_inter scale it ((float)v * slope + inter, two roundings: built
//       with -ffp-contract=off so no FMA fuses them, as numpy does not);
//   jig_write_nifti                    data/nifti.write_nifti_plain: the
//       caller passes the 352-byte header it builds, this writes it and the
//       voxels, deflated at `level` for .nii.gz;
//   jig_window_norm                    data/transforms.window_norm;
//   jig_remap_labels                   data/classes.remap_totalseg_labels
//       (equality with each id: a non-integer or out-of-table value maps
//       to 0, whatever its dtype);
//   jig_one_hot                        data/transforms.one_hot_np (float32).
//
// A file is read once: jig_open_nifti reads and parses the header and
// returns an open handle, the caller allocates the array of the header's
// shape and dtype, and jig_read_voxels inflates the voxels straight into it.
// Nothing is shared between calls: each handle has its own gzFile or FILE.
// Arrays are passed as (pointer, NIfTI datatype code); the codes are the
// ones of data/nifti._DTYPES.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <type_traits>
#include <vector>

#include <zlib.h>

// Run `body` with `T` the C type of NIfTI datatype `code`; `fail` otherwise.
#define JIG_DISPATCH(code, T, fail, ...)                    \
  switch (code) {                                           \
    case 2: { using T = uint8_t; __VA_ARGS__; } break;      \
    case 4: { using T = int16_t; __VA_ARGS__; } break;      \
    case 8: { using T = int32_t; __VA_ARGS__; } break;      \
    case 16: { using T = float; __VA_ARGS__; } break;       \
    case 64: { using T = double; __VA_ARGS__; } break;      \
    case 256: { using T = int8_t; __VA_ARGS__; } break;     \
    case 512: { using T = uint16_t; __VA_ARGS__; } break;   \
    case 768: { using T = uint32_t; __VA_ARGS__; } break;   \
    case 1024: { using T = int64_t; __VA_ARGS__; } break;   \
    case 1280: { using T = uint64_t; __VA_ARGS__; } break;  \
    default: fail;                                          \
  }

static int32_t itemsize(int32_t code) {
  int32_t size = 0;
  JIG_DISPATCH(code, T, return 0, size = (int32_t)sizeof(T))
  return size;
}

// ---------------------------------------------------------------------------
// read
// ---------------------------------------------------------------------------

struct JigHeader {
  int32_t ndim;         // dim[0], 1..7
  int32_t datatype;     // a code of data/nifti._DTYPES
  int64_t dims[7];      // dim[1..ndim], header order (x fastest)
  float pixdim[8];
  float scl_slope;
  float scl_inter;
  int32_t sform_code;
  int32_t big_endian;
  float srow[12];       // srow_x, srow_y, srow_z
};

struct JigFile {
  gzFile gz = nullptr;
  FILE* f = nullptr;
  bool big_endian = false;
};

// Bytes read into dst (fewer at the end of the file), or -1 on an error.
static int64_t read_bytes(JigFile* h, void* dst, int64_t n) {
  uint8_t* p = static_cast<uint8_t*>(dst);
  int64_t got = 0;
  while (got < n) {
    const int64_t want = n - got < (int64_t)1 << 30 ? n - got : (int64_t)1 << 30;
    int64_t r;
    if (h->gz) {
      r = gzread(h->gz, p + got, (unsigned)want);
    } else {
      r = (int64_t)fread(p + got, 1, (size_t)want, h->f);
      if (r < want && ferror(h->f)) return -1;
    }
    if (r < 0) return -1;
    got += r;
    if (r < want) break;
  }
  return got;
}

static void swap_bytes(uint8_t* p, int64_t count, int32_t size) {
  if (size == 1) return;
  for (int64_t i = 0; i < count; ++i, p += size)
    for (int32_t a = 0, b = size - 1; a < b; ++a, --b) {
      const uint8_t t = p[a];
      p[a] = p[b];
      p[b] = t;
    }
}

template <typename T>
static T field(const uint8_t* hdr, int offset, bool big_endian) {
  T v;
  memcpy(&v, hdr + offset, sizeof(T));
  if (big_endian) swap_bytes(reinterpret_cast<uint8_t*>(&v), 1, sizeof(T));
  return v;
}

extern "C" void jig_close_nifti(void* handle) {
  JigFile* h = static_cast<JigFile*>(handle);
  if (!h) return;
  if (h->gz) gzclose(h->gz);
  if (h->f) fclose(h->f);
  delete h;
}

// Open `path` (gzip when `gz`), read and parse its 348-byte header into
// `out` and leave the handle at the first voxel.  Null when this reader
// leaves the file to the numpy one: it cannot be opened or read, it is no
// NIfTI-1 file, or it has a datatype, a dim[0] or a vox_offset outside what
// is decoded here (the numpy reader then decodes it or raises its error).
extern "C" void* jig_open_nifti(const char* path, int32_t gz, JigHeader* out) {
  JigFile* h = new JigFile();
  if (gz) {
    h->gz = gzopen(path, "rb");
    if (h->gz) gzbuffer(h->gz, 1 << 18);
  } else {
    h->f = fopen(path, "rb");
  }
  uint8_t hdr[348];
  // a .gz path that holds no gzip stream is the numpy reader's to refuse
  if ((!h->gz && !h->f) || read_bytes(h, hdr, 348) != 348 || (h->gz && gzdirect(h->gz))) {
    jig_close_nifti(h);
    return nullptr;
  }
  int32_t sizeof_hdr;
  memcpy(&sizeof_hdr, hdr, 4);
  if (sizeof_hdr != 348) {
    h->big_endian = true;
    if (field<int32_t>(hdr, 0, true) != 348) { jig_close_nifti(h); return nullptr; }
  }
  const bool big = h->big_endian;
  if (memcmp(hdr + 344, "n+1\0", 4) != 0 && memcmp(hdr + 344, "ni1\0", 4) != 0) {
    jig_close_nifti(h);
    return nullptr;
  }
  const int16_t ndim = field<int16_t>(hdr, 40, big);
  out->datatype = field<int16_t>(hdr, 70, big);
  const float vox_offset = field<float>(hdr, 108, big);
  bool ok = ndim >= 1 && ndim <= 7 && itemsize(out->datatype) > 0 && std::isfinite(vox_offset) &&
            vox_offset < 1e15f;
  out->ndim = ndim;
  for (int i = 0; ok && i < ndim; ++i) {
    out->dims[i] = field<int16_t>(hdr, 42 + 2 * i, big);
    ok = out->dims[i] >= 0;
  }
  if (!ok) { jig_close_nifti(h); return nullptr; }
  for (int i = 0; i < 8; ++i) out->pixdim[i] = field<float>(hdr, 76 + 4 * i, big);
  out->scl_slope = field<float>(hdr, 112, big);
  out->scl_inter = field<float>(hdr, 116, big);
  out->sform_code = field<int16_t>(hdr, 254, big);
  for (int i = 0; i < 12; ++i) out->srow[i] = field<float>(hdr, 280 + 4 * i, big);
  out->big_endian = big;
  // the voxels start at max(int(vox_offset), 348), as the numpy reader reads them
  const int64_t skip = (int64_t)vox_offset - 348;
  if (skip > 0) {
    if (h->gz) {
      ok = gzseek(h->gz, (z_off_t)skip, SEEK_CUR) == (z_off_t)(348 + skip);
    } else {
      ok = fseek(h->f, (long)skip, SEEK_CUR) == 0;
    }
    if (!ok) { jig_close_nifti(h); return nullptr; }
  }
  return h;
}

template <typename T>
static void scale(const uint8_t* raw, float* dst, int64_t n, float slope, float inter) {
  const T* s = reinterpret_cast<const T*>(raw);
  for (int64_t i = 0; i < n; ++i) dst[i] = (float)s[i] * slope + inter;
}

// Read `count` voxels of the opened file into `out`: as stored, in the
// machine's byte order, or with `scaled` as float32 (float)v * slope + inter.
// 0, or 1 when the file ends early or a read fails (nothing of `out` is
// then to be used).  The handle stays open: jig_close_nifti frees it.
extern "C" int32_t jig_read_voxels(void* handle, int32_t datatype, int64_t count, void* out, int32_t scaled,
                                   float slope, float inter) {
  JigFile* h = static_cast<JigFile*>(handle);
  const int32_t size = itemsize(datatype);
  if (!scaled) {
    if (read_bytes(h, out, count * size) != count * size) return 1;
    if (h->big_endian) swap_bytes(static_cast<uint8_t*>(out), count, size);
    return 0;
  }
  const int64_t chunk = ((int64_t)1 << 20) / size;
  std::vector<uint8_t> raw((size_t)(chunk * size));
  float* dst = static_cast<float*>(out);
  for (int64_t done = 0; done < count; done += chunk) {
    const int64_t n = count - done < chunk ? count - done : chunk;
    if (read_bytes(h, raw.data(), n * size) != n * size) return 1;
    if (h->big_endian) swap_bytes(raw.data(), n, size);
    JIG_DISPATCH(datatype, T, return 1, scale<T>(raw.data(), dst + done, n, slope, inter))
  }
  return 0;
}

// ---------------------------------------------------------------------------
// write
// ---------------------------------------------------------------------------

static int32_t errno_or_eio() { return errno ? errno : EIO; }

// Write `header` then `payload` to `path`, deflated at gzip `level` when
// `gz`.  0, or the errno of the failure (EIO where the library gives none).
extern "C" int32_t jig_write_nifti(const char* path, int32_t gz, int32_t level, const void* header,
                                   int64_t header_bytes, const void* payload, int64_t payload_bytes) {
  errno = 0;
  if (!gz) {
    FILE* f = fopen(path, "wb");
    if (!f) return errno_or_eio();
    const bool ok = fwrite(header, 1, (size_t)header_bytes, f) == (size_t)header_bytes &&
                    fwrite(payload, 1, (size_t)payload_bytes, f) == (size_t)payload_bytes;
    const int32_t err = ok ? 0 : errno_or_eio();
    if (fclose(f) != 0 && ok) return errno_or_eio();
    return err;
  }
  const char mode[4] = {'w', 'b', (char)('0' + (level < 0 ? 0 : level > 9 ? 9 : level)), 0};
  gzFile f = gzopen(path, mode);
  if (!f) return errno_or_eio();
  gzbuffer(f, 1 << 18);
  const uint8_t* parts[2] = {static_cast<const uint8_t*>(header), static_cast<const uint8_t*>(payload)};
  const int64_t sizes[2] = {header_bytes, payload_bytes};
  for (int k = 0; k < 2; ++k)
    for (int64_t off = 0; off < sizes[k];) {
      const unsigned n = (unsigned)(sizes[k] - off < ((int64_t)1 << 30) ? sizes[k] - off : (int64_t)1 << 30);
      if (gzwrite(f, parts[k] + off, n) != (int)n) {
        int zerr;
        gzerror(f, &zerr);
        const int32_t err = zerr == Z_ERRNO ? errno_or_eio() : EIO;
        gzclose(f);
        return err;
      }
      off += n;
    }
  const int rc = gzclose(f);
  return rc == Z_OK ? 0 : rc == Z_ERRNO ? errno_or_eio() : EIO;
}

// ---------------------------------------------------------------------------
// window, remap, one-hot
// ---------------------------------------------------------------------------

// np.clip(v, 0, 1) on float32: NaN stays, -0.0 becomes 0.0
static inline float clip01(float v) {
  if (std::isnan(v)) return v;
  v = v > 0.f ? v : 0.f;
  return v < 1.f ? v : 1.f;
}

template <typename T>
static void window(const T* src, float* out, int64_t n, float lo, float width) {
  for (int64_t i = 0; i < n; ++i) out[i] = clip01(((float)src[i] - lo) / width);
}

// out = clip(((float)src - lo) / width, 0, 1); 1 for an unknown code.
extern "C" int32_t jig_window_norm(const void* src, int32_t code, float* out, int64_t n, float lo, float width) {
  JIG_DISPATCH(code, T, return 1, window<T>(static_cast<const T*>(src), out, n, lo, width))
  return 0;
}

template <typename T>
static inline int32_t lookup(T v, const int32_t* lut) {
  if constexpr (std::is_floating_point_v<T>) {
    // equal to some id of the table: a whole number in [0, 256)
    return v >= 0 && v < 256 && v == (T)(int32_t)v ? lut[(int32_t)v] : 0;
  } else if constexpr (std::is_signed_v<T>) {
    return v >= 0 && v < 256 ? lut[v] : 0;
  } else {
    return v < 256 ? lut[v] : 0;
  }
}

template <typename S, typename M>
static void remap(const S* seg, const M* tumor, int32_t* out, int64_t n, const int32_t* lut, int32_t tumor_class) {
  if (tumor) {
    for (int64_t i = 0; i < n; ++i) out[i] = tumor[i] > 0 ? tumor_class : lookup(seg[i], lut);
  } else {
    for (int64_t i = 0; i < n; ++i) out[i] = lookup(seg[i], lut);
  }
}

// out[i] = k + 1 where seg[i] == ids[k] (the last such k), else 0; then
// tumor_class where tumor[i] > 0 (tumor null: no tumour).  Every id must lie
// in [0, 256).  1 for an unknown code or id.
extern "C" int32_t jig_remap_labels(const void* seg, int32_t seg_code, const void* tumor, int32_t tumor_code,
                                    int32_t* out, int64_t n, const int32_t* ids, int32_t n_ids,
                                    int32_t tumor_class) {
  int32_t lut[256] = {0};
  for (int32_t k = 0; k < n_ids; ++k) {
    if (ids[k] < 0 || ids[k] >= 256) return 1;
    lut[ids[k]] = k + 1;
  }
  if (!tumor) tumor_code = 2;
  JIG_DISPATCH(seg_code, S, return 1,
    JIG_DISPATCH(tumor_code, M, return 1,
      remap<S, M>(static_cast<const S*>(seg), static_cast<const M*>(tumor), out, n, lut, tumor_class)))
  return 0;
}

template <typename T>
static void one_hot(const T* labels, float* out, int64_t n, int64_t classes) {
  memset(out, 0, sizeof(float) * (size_t)(n * classes));
  for (int64_t i = 0; i < n; ++i) {
    const T v = labels[i];
    int64_t c;
    if constexpr (std::is_signed_v<T>) {
      c = v < 0 ? 0 : (int64_t)v;
    } else {
      c = (int64_t)(v > (T)INT64_MAX ? (T)INT64_MAX : v);
    }
    out[i * classes + (c < classes - 1 ? c : classes - 1)] = 1.0f;
  }
}

// out (n, classes) float32 = the one-hot of labels clipped into [0, classes);
// 1 for an unknown or floating code.
extern "C" int32_t jig_one_hot(const void* labels, int32_t code, float* out, int64_t n, int32_t classes) {
  if (code == 16 || code == 64 || classes < 1) return 1;
  JIG_DISPATCH(code, T, return 1, one_hot<T>(static_cast<const T*>(labels), out, n, classes))
  return 0;
}
