// GROMACS XTC trajectory codec (xdr3dfcoord algorithm), C ABI.
//
// The raw 4AA/ATLAS releases ship as .xtc; the reference reads them through
// mdtraj's binary xdrfile build (src/utils/traj_utils.py:25-41). This is a
// from-scratch implementation of the public XTC format so the data tools
// (lam_slide_tpu_torch/tools/process_4aa.py) ingest raw trajectories without mdtraj: XDR
// big-endian framing (magic 1995) and the 3dfcoord fixed-point compression
// — per-frame int quantization at `precision`, min/max bounding, the
// magicints size ladder, multiprecision base-256 packing of coordinate
// triples (encodeints/decodeints), and run-length encoded "small" diffs
// with the water-molecule first/second atom interchange.
//
// Validated by write→read round-trips across sizes/precisions (including
// the ≤9-atom uncompressed path) in tests/test_torch_port_xtc.py; quantization error
// is bounded by 1/(2·precision) by construction.

#include <cmath>
#include <cstdlib>
#include <climits>
#include <cstdint>
#include <cstring>

namespace {

const int magicints[] = {
    0,       0,       0,       0,       0,        0,        0,        0,
    0,       8,       10,      12,      16,       20,       25,       32,
    40,      50,      64,      80,      101,      128,      161,      203,
    256,     322,     406,     512,     645,      812,      1024,     1290,
    1625,    2048,    2580,    3250,    4096,     5060,     6501,     8192,
    10321,   13003,   16384,   20642,   26007,    32768,    41285,    52015,
    65536,   82570,   104031,  131072,  165140,   208063,   262144,   330280,
    416127,  524287,  660561,  832255,  1048576,  1321122,  1664510,  2097152,
    2642245, 3329021, 4194304, 5284491, 6658042,  8388607,  10568983, 13316085,
    16777216};
const int FIRSTIDX = 9;
const int LASTIDX = static_cast<int>(sizeof(magicints) / sizeof(*magicints));

// ---- XDR primitives (big endian) -----------------------------------------

struct Reader {
  const uint8_t* data;
  int64_t len;
  int64_t pos = 0;
  bool ok = true;

  bool need(int64_t n) {
    if (pos + n > len) { ok = false; return false; }
    return true;
  }
  int32_t read_i32() {
    if (!need(4)) return 0;
    int32_t v = (int32_t)((uint32_t)data[pos] << 24 | (uint32_t)data[pos + 1] << 16 |
                          (uint32_t)data[pos + 2] << 8 | (uint32_t)data[pos + 3]);
    pos += 4;
    return v;
  }
  float read_f32() {
    int32_t v = read_i32();
    float f;
    std::memcpy(&f, &v, 4);
    return f;
  }
};

struct Writer {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;
  bool ok = true;

  bool need(int64_t n) {
    if (pos + n > cap) { ok = false; return false; }
    return true;
  }
  void write_i32(int32_t v) {
    if (!need(4)) return;
    out[pos++] = (uint8_t)((uint32_t)v >> 24);
    out[pos++] = (uint8_t)((uint32_t)v >> 16);
    out[pos++] = (uint8_t)((uint32_t)v >> 8);
    out[pos++] = (uint8_t)v;
  }
  void write_f32(float f) {
    int32_t v;
    std::memcpy(&v, &f, 4);
    write_i32(v);
  }
};

// ---- bit buffer (xdrfile encodebits/decodebits semantics) ----------------

struct BitWriter {
  uint8_t* cbuf;
  int64_t cap;
  uint32_t cnt = 0, lastbits = 0, lastbyte = 0;
  bool ok = true;

  void put(int num_of_bits, uint32_t num) {
    while (num_of_bits >= 8) {
      lastbyte = (lastbyte << 8) | ((num >> (num_of_bits - 8)) & 0xff);
      if (cnt >= cap) { ok = false; return; }
      cbuf[cnt++] = (uint8_t)(lastbyte >> lastbits);
      num_of_bits -= 8;
    }
    if (num_of_bits > 0) {
      lastbyte = (lastbyte << num_of_bits) | (num & ((1u << num_of_bits) - 1));
      lastbits += num_of_bits;
      if (lastbits >= 8) {
        lastbits -= 8;
        if (cnt >= cap) { ok = false; return; }
        cbuf[cnt++] = (uint8_t)(lastbyte >> lastbits);
      }
    }
  }
  uint32_t flush() {  // -> total bytes incl. partial
    if (lastbits > 0) {
      if (cnt >= cap) { ok = false; return cnt; }
      cbuf[cnt] = (uint8_t)(lastbyte << (8 - lastbits));
      return cnt + 1;
    }
    return cnt;
  }
};

struct BitReader {
  const uint8_t* cbuf;
  int64_t len;
  uint32_t cnt = 0, lastbits = 0, lastbyte = 0;
  bool ok = true;

  uint32_t get(int num_of_bits) {
    uint32_t mask = num_of_bits >= 32 ? 0xffffffffu : ((1u << num_of_bits) - 1);
    uint32_t num = 0;
    while (num_of_bits >= 8) {
      if (cnt >= len) { ok = false; return 0; }
      lastbyte = (lastbyte << 8) | cbuf[cnt++];
      num |= (lastbyte >> lastbits) << (num_of_bits - 8);
      num_of_bits -= 8;
    }
    if (num_of_bits > 0) {
      if ((int)lastbits < num_of_bits) {
        if (cnt >= len) { ok = false; return 0; }
        lastbits += 8;
        lastbyte = (lastbyte << 8) | cbuf[cnt++];
      }
      lastbits -= num_of_bits;
      num |= (lastbyte >> lastbits) & ((1u << num_of_bits) - 1);
    }
    return num & mask;
  }
};

// ---- integer packing -----------------------------------------------------

int sizeofint(uint32_t size) {
  uint32_t num = 1;
  int nbits = 0;
  while (size >= num && nbits < 32) {
    nbits++;
    num <<= 1;
  }
  return nbits;
}

int sizeofints(int n, const uint32_t sizes[]) {
  uint8_t bytes[32];
  int num_of_bytes = 1;
  bytes[0] = 1;
  int num_of_bits = 0;
  for (int i = 0; i < n; i++) {
    uint32_t tmp = 0;
    int bytecnt;
    for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
      tmp = bytes[bytecnt] * sizes[i] + tmp;
      bytes[bytecnt] = tmp & 0xff;
      tmp >>= 8;
    }
    while (tmp != 0) {
      bytes[bytecnt++] = tmp & 0xff;
      tmp >>= 8;
    }
    num_of_bytes = bytecnt;
  }
  uint32_t num = 1;
  num_of_bytes--;
  while (bytes[num_of_bytes] >= num) {
    num_of_bits++;
    num *= 2;
  }
  return num_of_bits + num_of_bytes * 8;
}

void encodeints(BitWriter& bw, int n, int num_of_bits, const uint32_t sizes[],
                const uint32_t nums[]) {
  uint8_t bytes[32];
  uint32_t tmp = nums[0];
  int num_of_bytes = 0;
  do {
    bytes[num_of_bytes++] = tmp & 0xff;
    tmp >>= 8;
  } while (tmp != 0);
  for (int i = 1; i < n; i++) {
    tmp = nums[i];
    int bytecnt;
    for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
      tmp = bytes[bytecnt] * sizes[i] + tmp;
      bytes[bytecnt] = tmp & 0xff;
      tmp >>= 8;
    }
    while (tmp != 0) {
      bytes[bytecnt++] = tmp & 0xff;
      tmp >>= 8;
    }
    num_of_bytes = bytecnt;
  }
  if (num_of_bits >= num_of_bytes * 8) {
    for (int i = 0; i < num_of_bytes; i++) bw.put(8, bytes[i]);
    bw.put(num_of_bits - num_of_bytes * 8, 0);
  } else {
    int i;
    for (i = 0; i < num_of_bytes - 1; i++) bw.put(8, bytes[i]);
    bw.put(num_of_bits - (num_of_bytes - 1) * 8, bytes[i]);
  }
}

void decodeints(BitReader& br, int n, int num_of_bits, const uint32_t sizes[],
                int32_t nums[]) {
  uint8_t bytes[32] = {0};
  int num_of_bytes = 0;
  while (num_of_bits > 8) {
    bytes[num_of_bytes++] = (uint8_t)br.get(8);
    num_of_bits -= 8;
  }
  if (num_of_bits > 0) bytes[num_of_bytes++] = (uint8_t)br.get(num_of_bits);
  for (int i = n - 1; i > 0; i--) {
    uint32_t num = 0;
    for (int j = num_of_bytes - 1; j >= 0; j--) {
      num = (num << 8) | bytes[j];
      uint32_t p = num / sizes[i];
      bytes[j] = (uint8_t)p;
      num = num - p * sizes[i];
    }
    nums[i] = (int32_t)num;
  }
  nums[0] = (int32_t)((uint32_t)bytes[0] | ((uint32_t)bytes[1] << 8) |
                      ((uint32_t)bytes[2] << 16) | ((uint32_t)bytes[3] << 24));
}

inline int32_t quantize(float x, float precision) {
  float lf = x * precision;
  return (int32_t)(lf >= 0 ? lf + 0.5f : lf - 0.5f);
}

}  // namespace

extern "C" {

// Decode one frame starting at *offset; advances *offset past the frame.
// Returns natoms on success, 0 at clean end of data, -1 on error.
// coords must hold natoms*3 floats (call xtc_peek_natoms first).
int32_t xtc_decode_frame(const uint8_t* data, int64_t len, int64_t* offset,
                         int32_t* step, float* time, float* box9,
                         float* coords, int64_t coords_cap) {
  if (*offset >= len) return 0;
  Reader r{data, len};
  r.pos = *offset;
  int32_t magic = r.read_i32();
  if (!r.ok || magic != 1995) return -1;
  int32_t natoms = r.read_i32();
  *step = r.read_i32();
  *time = r.read_f32();
  for (int i = 0; i < 9; i++) box9[i] = r.read_f32();
  if (!r.ok || natoms <= 0 || (int64_t)natoms * 3 > coords_cap) return -1;

  int32_t lsize = r.read_i32();
  if (!r.ok || lsize != natoms) return -1;
  if (natoms <= 9) {  // uncompressed small system (no precision field)
    for (int i = 0; i < natoms * 3; i++) coords[i] = r.read_f32();
    if (!r.ok) return -1;
    *offset = r.pos;
    return natoms;
  }

  float precision = r.read_f32();
  int32_t minint[3], maxint[3];
  for (int k = 0; k < 3; k++) minint[k] = r.read_i32();
  for (int k = 0; k < 3; k++) maxint[k] = r.read_i32();
  int32_t smallidx = r.read_i32();
  int32_t nbytes = r.read_i32();
  // corrupt-input guards: every violation below would otherwise be an
  // out-of-bounds magicints read, a zero division in decodeints, or a
  // runaway loop — fail as a decode error instead of crashing the process
  if (!r.ok || nbytes < 0 || r.pos + nbytes > len) return -1;
  if (!(precision > 0.0f) || smallidx < FIRSTIDX || smallidx >= LASTIDX) return -1;
  for (int k = 0; k < 3; k++) {
    if (maxint[k] < minint[k]) return -1;
    if ((int64_t)maxint[k] - minint[k] >= (int64_t)INT32_MAX) return -1;
  }

  uint32_t sizeint[3], bitsizeint[3] = {0, 0, 0};
  for (int k = 0; k < 3; k++) sizeint[k] = (uint32_t)(maxint[k] - minint[k]) + 1;
  int bitsize;
  if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
    for (int k = 0; k < 3; k++) bitsizeint[k] = sizeofint(sizeint[k]);
    bitsize = 0;
  } else {
    bitsize = sizeofints(3, sizeint);
  }

  int tmpidx = smallidx - 1;
  tmpidx = (FIRSTIDX > tmpidx) ? FIRSTIDX : tmpidx;
  int smaller = magicints[tmpidx] / 2;
  int small = magicints[smallidx] / 2;
  uint32_t sizesmall[3];
  sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)magicints[smallidx];

  BitReader br{data + r.pos, nbytes};
  float inv_precision = 1.0f / precision;
  int32_t prevcoord[3] = {0, 0, 0};
  int32_t thiscoord[3];
  float* lfp = coords;
  int run = 0;
  int i = 0;
  while (i < lsize) {
    if (bitsize == 0) {
      thiscoord[0] = (int32_t)br.get(bitsizeint[0]);
      thiscoord[1] = (int32_t)br.get(bitsizeint[1]);
      thiscoord[2] = (int32_t)br.get(bitsizeint[2]);
    } else {
      decodeints(br, 3, bitsize, sizeint, thiscoord);
    }
    i++;
    for (int k = 0; k < 3; k++) {
      thiscoord[k] += minint[k];
      prevcoord[k] = thiscoord[k];
    }

    int flag = (int)br.get(1);
    int is_smaller = 0;
    if (flag == 1) {
      run = (int)br.get(5);
      is_smaller = run % 3;
      run -= is_smaller;
      is_smaller--;
    }
    if (run < 0 || run > 8 * 3 || i + run / 3 > lsize) return -1;
    if (smallidx + is_smaller < FIRSTIDX || smallidx + is_smaller >= LASTIDX)
      return -1;
    if (run > 0) {
      for (int k = 0; k < run; k += 3) {
        decodeints(br, 3, smallidx, sizesmall, thiscoord);
        i++;
        for (int d = 0; d < 3; d++) thiscoord[d] += prevcoord[d] - small;
        if (k == 0) {
          // interchange first with second atom (water-molecule optimization)
          for (int d = 0; d < 3; d++) {
            int32_t t = thiscoord[d];
            thiscoord[d] = prevcoord[d];
            prevcoord[d] = t;
          }
          for (int d = 0; d < 3; d++) *lfp++ = prevcoord[d] * inv_precision;
        } else {
          for (int d = 0; d < 3; d++) prevcoord[d] = thiscoord[d];
        }
        for (int d = 0; d < 3; d++) *lfp++ = thiscoord[d] * inv_precision;
      }
    } else {
      for (int d = 0; d < 3; d++) *lfp++ = thiscoord[d] * inv_precision;
    }
    smallidx += is_smaller;
    if (is_smaller < 0) {
      small = smaller;
      smaller = (smallidx > FIRSTIDX) ? magicints[smallidx - 1] / 2 : 0;
    } else if (is_smaller > 0) {
      smaller = small;
      small = magicints[smallidx] / 2;
    }
    sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)magicints[smallidx];
    if (!br.ok) return -1;
  }
  *offset = r.pos + ((nbytes + 3) / 4) * 4;  // opaque data is 4-byte padded
  return natoms;
}

// Peek the atom count of the frame at *offset (no state change); -1 on error.
int32_t xtc_peek_natoms(const uint8_t* data, int64_t len, int64_t offset) {
  Reader r{data, len};
  r.pos = offset;
  int32_t magic = r.read_i32();
  int32_t natoms = r.read_i32();
  if (!r.ok || magic != 1995) return -1;
  return natoms;
}

// Encode one frame; returns bytes written or -1 (out too small / error).
int64_t xtc_encode_frame(int32_t natoms, int32_t step, float time,
                         const float* box9, const float* coords,
                         float precision, uint8_t* out, int64_t out_cap) {
  Writer w{out, out_cap};
  w.write_i32(1995);
  w.write_i32(natoms);
  w.write_i32(step);
  w.write_f32(time);
  for (int i = 0; i < 9; i++) w.write_f32(box9[i]);
  w.write_i32(natoms);
  if (!w.ok) return -1;

  if (natoms <= 9) {
    for (int i = 0; i < natoms * 3; i++) w.write_f32(coords[i]);
    return w.ok ? w.pos : -1;
  }

  w.write_f32(precision);
  const int64_t size = natoms;
  // quantize + bounds + min consecutive-atom L1 diff
  int32_t minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
  int32_t maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
  int32_t* lip = new int32_t[size * 3];
  int64_t mindiff = INT64_MAX;
  int32_t oldl[3] = {0, 0, 0};
  for (int64_t i = 0; i < size; i++) {
    int32_t l[3];
    for (int d = 0; d < 3; d++) {
      l[d] = quantize(coords[i * 3 + d], precision);
      lip[i * 3 + d] = l[d];
      if (l[d] < minint[d]) minint[d] = l[d];
      if (l[d] > maxint[d]) maxint[d] = l[d];
    }
    if (i > 0) {
      int64_t diff = llabs((int64_t)l[0] - oldl[0]) +
                     llabs((int64_t)l[1] - oldl[1]) +
                     llabs((int64_t)l[2] - oldl[2]);
      if (diff < mindiff) mindiff = diff;
    }
    for (int d = 0; d < 3; d++) oldl[d] = l[d];
  }
  for (int k = 0; k < 3; k++) w.write_i32(minint[k]);
  for (int k = 0; k < 3; k++) w.write_i32(maxint[k]);

  uint32_t sizeint[3], bitsizeint[3] = {0, 0, 0};
  for (int k = 0; k < 3; k++) sizeint[k] = (uint32_t)(maxint[k] - minint[k]) + 1;
  int bitsize;
  if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
    for (int k = 0; k < 3; k++) bitsizeint[k] = sizeofint(sizeint[k]);
    bitsize = 0;
  } else {
    bitsize = sizeofints(3, sizeint);
  }

  int smallidx = FIRSTIDX;
  while (smallidx < LASTIDX - 1 && magicints[smallidx] < mindiff) smallidx++;
  w.write_i32(smallidx);
  if (!w.ok) { delete[] lip; return -1; }

  int maxidx = (LASTIDX - 1 < smallidx + 8) ? LASTIDX - 1 : smallidx + 8;
  int minidx = maxidx - 8;
  int smaller = magicints[(FIRSTIDX > smallidx - 1) ? FIRSTIDX : smallidx - 1] / 2;
  int small = magicints[smallidx] / 2;
  uint32_t sizesmall[3];
  sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)magicints[smallidx];
  int larger = magicints[maxidx] / 2;

  // compressed payload: worst case ~ 4 ints/atom + headers
  int64_t scratch_cap = size * 16 + 1024;
  uint8_t* scratch = new uint8_t[scratch_cap];
  BitWriter bw{scratch, scratch_cap};

  int32_t prevcoord[3] = {0, 0, 0};
  uint32_t tmpcoord[32];
  int prevrun = -1;
  int64_t i = 0;
  while (i < size) {
    int is_small = 0;
    int32_t* thiscoord = lip + i * 3;
    int is_smaller;
    if (smallidx < maxidx && i >= 1 &&
        std::abs(thiscoord[0] - prevcoord[0]) < larger &&
        std::abs(thiscoord[1] - prevcoord[1]) < larger &&
        std::abs(thiscoord[2] - prevcoord[2]) < larger) {
      is_smaller = 1;
    } else if (smallidx > minidx) {
      is_smaller = -1;
    } else {
      is_smaller = 0;
    }
    if (i + 1 < size) {
      if (std::abs(thiscoord[0] - thiscoord[3]) < small &&
          std::abs(thiscoord[1] - thiscoord[4]) < small &&
          std::abs(thiscoord[2] - thiscoord[5]) < small) {
        // interchange first with second atom (water-molecule optimization)
        for (int d = 0; d < 3; d++) {
          int32_t t = thiscoord[d];
          thiscoord[d] = thiscoord[d + 3];
          thiscoord[d + 3] = t;
        }
        is_small = 1;
      }
    }
    uint32_t tc[3];
    for (int d = 0; d < 3; d++) tc[d] = (uint32_t)(thiscoord[d] - minint[d]);
    if (bitsize == 0) {
      for (int d = 0; d < 3; d++) bw.put(bitsizeint[d], tc[d]);
    } else {
      encodeints(bw, 3, bitsize, sizeint, tc);
    }
    for (int d = 0; d < 3; d++) prevcoord[d] = thiscoord[d];
    thiscoord += 3;
    i++;

    int run = 0;
    if (is_small == 0 && is_smaller == -1) is_smaller = 0;
    while (is_small && run < 8 * 3) {
      if (is_smaller == -1) {
        int64_t d0 = thiscoord[0] - prevcoord[0];
        int64_t d1 = thiscoord[1] - prevcoord[1];
        int64_t d2 = thiscoord[2] - prevcoord[2];
        if (d0 * d0 + d1 * d1 + d2 * d2 >= (int64_t)smaller * smaller)
          is_smaller = 0;
      }
      for (int d = 0; d < 3; d++) {
        tmpcoord[run++] = (uint32_t)(thiscoord[d] - prevcoord[d] + small);
        prevcoord[d] = thiscoord[d];
      }
      i++;
      thiscoord += 3;
      is_small = 0;
      if (i < size && std::abs(thiscoord[0] - prevcoord[0]) < small &&
          std::abs(thiscoord[1] - prevcoord[1]) < small &&
          std::abs(thiscoord[2] - prevcoord[2]) < small) {
        is_small = 1;
      }
    }
    if (run != prevrun || is_smaller != 0) {
      prevrun = run;
      bw.put(1, 1);
      bw.put(5, (uint32_t)(run + is_smaller + 1));
    } else {
      bw.put(1, 0);
    }
    for (int k = 0; k < run; k += 3) {
      encodeints(bw, 3, smallidx, sizesmall, &tmpcoord[k]);
    }
    if (is_smaller != 0) {
      smallidx += is_smaller;
      if (is_smaller < 0) {
        small = smaller;
        smaller = magicints[smallidx - 1] / 2;
      } else {
        smaller = small;
        small = magicints[smallidx] / 2;
      }
      sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)magicints[smallidx];
    }
  }
  delete[] lip;
  uint32_t nbytes = bw.flush();
  if (!bw.ok) { delete[] scratch; return -1; }
  w.write_i32((int32_t)nbytes);
  uint32_t padded = ((nbytes + 3) / 4) * 4;
  if (!w.need(padded)) { delete[] scratch; return -1; }
  std::memcpy(w.out + w.pos, scratch, nbytes);
  std::memset(w.out + w.pos + nbytes, 0, padded - nbytes);
  w.pos += padded;
  delete[] scratch;
  return w.ok ? w.pos : -1;
}

}  // extern "C"
