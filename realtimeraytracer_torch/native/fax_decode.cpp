// CCITT fax strips and tiles of a TIFF (the third source of the image
// decoder library), decoded as libtiff 4.7's tif_fax3.c decodes them for
// Pillow: Modified Huffman RLE (compression 2, rows byte-aligned; 32771,
// rows word-aligned), T.4 (compression 3: 1-D, or 2-D rows by T4Options
// bit 0) and T.6 (compression 4).  The code tables are built as
// mkg3states.c builds TIFFFaxMainTable, TIFFFaxWhiteTable and
// TIFFFaxBlackTable; the row expanders follow tif_fax3.h's macros,
// libtiff's recovery from bad data included: a bad code word ends its row
// (the rest of the row white, a run too long cut), a T.4 row is found by
// its EOL, and a T.6 strip that ends early keeps the rows decoded before
// it (a tile stands whatever ends it).  The input is read most significant bit first (the caller has
// reversed the bytes of a FillOrder 2 file); a white run writes 0 bits and
// a black run 1 bits, whatever the photometric, as libtiff hands them on.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace fax {

namespace {

enum { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL };

struct Ent {
  uint8_t state = S_Null, width = 0;
  uint32_t param = 0;
};

// T.4's code words, most significant bit first, by run length.
const char* const kTermW[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100", "00111", "01000",
    "001000", "000011", "110100", "110101", "101010", "101011", "0100111", "0001100", "0001000", "0010111",
    "0000011", "0000100", "0101000", "0101011", "0010011", "0100100", "0011000", "00000010", "00000011",
    "00011010", "00011011", "00010010", "00010011", "00010100", "00010101", "00010110", "00010111", "00101000",
    "00101001", "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010", "00001011",
    "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000", "01011001", "01011010",
    "01011011", "01001010", "01001011", "00110010", "00110011", "00110100"};
const char* const kMakeUpW[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101", "01101000",
    "01100111", "011001100", "011001101", "011010010", "011010011", "011010100", "011010101", "011010110",
    "011010111", "011011000", "011011001", "011011010", "011011011", "010011000", "010011001", "010011010",
    "011000", "010011011"};
const char* const kTermB[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100", "0000100", "0000101",
    "0000111", "00000100", "00000111", "000011000", "0000010111", "0000011000", "0000001000", "00001100111",
    "00001101000", "00001101100", "00000110111", "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010", "000011011011", "000001010100",
    "000001010101", "000001010110", "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000", "000000100111", "000000101000",
    "000001011000", "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kMakeUpB[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011", "000000110100",
    "000000110101", "0000001101100", "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100", "0000001110101", "0000001110110",
    "0000001110111", "0000001010010", "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* const kMakeUp[13] = {  // 1792-2560, both colours
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011", "000000010100",
    "000000010101", "000000010110", "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

// mkg3states' FillTable: every index of a `size`-bit table whose low bits,
// read first to last, spell the code.
void fill(Ent* t, int size, const char* code, int state, uint32_t param) {
  const int width = int(std::strlen(code));
  int lsb = 0;
  for (int i = 0; i < width; ++i) lsb |= (code[i] - '0') << i;
  for (int c = lsb; c < (1 << size); c += 1 << width) t[c] = Ent{uint8_t(state), uint8_t(width), param};
}

struct Tables {
  Ent main[128], white[4096], black[8192];
  Tables() {
    fill(main, 7, "0001", S_Pass, 0);
    fill(main, 7, "001", S_Horiz, 0);
    fill(main, 7, "1", S_V0, 0);
    const char* vr[3] = {"011", "000011", "0000011"};
    const char* vl[3] = {"010", "000010", "0000010"};
    for (int k = 0; k < 3; ++k) fill(main, 7, vr[k], S_VR, uint32_t(k + 1));
    for (int k = 0; k < 3; ++k) fill(main, 7, vl[k], S_VL, uint32_t(k + 1));
    fill(main, 7, "0000001", S_Ext, 0);
    fill(main, 7, "0000000", S_EOL, 0);
    for (int k = 0; k < 27; ++k) fill(white, 12, kMakeUpW[k], S_MakeUpW, uint32_t(64 * (k + 1)));
    for (int k = 0; k < 13; ++k) fill(white, 12, kMakeUp[k], S_MakeUp, uint32_t(1792 + 64 * k));
    for (int k = 0; k < 64; ++k) fill(white, 12, kTermW[k], S_TermW, uint32_t(k));
    fill(white, 12, "00000000000", S_EOL, 0);
    for (int k = 0; k < 27; ++k) fill(black, 13, kMakeUpB[k], S_MakeUpB, uint32_t(64 * (k + 1)));
    for (int k = 0; k < 13; ++k) fill(black, 13, kMakeUp[k], S_MakeUp, uint32_t(1792 + 64 * k));
    for (int k = 0; k < 64; ++k) fill(black, 13, kTermB[k], S_TermB, uint32_t(k));
    fill(black, 13, "00000000000", S_EOL, 0);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

uint8_t rev8(uint8_t b) {
  b = uint8_t((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = uint8_t((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return uint8_t((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// libtiff's _TIFFFax3fillruns: runs alternately white (0 bits) and black
// (1 bits) from the row's start; a run past the row is cut (in the array
// too, which the next row reads as its reference).
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  auto paint = [&](uint32_t& slot, bool black) {
    uint32_t run = slot;
    if (x + run > lastx || run > lastx) run = slot = lastx - x;
    for (uint32_t i = x; i < x + run; ++i) {
      if (black) buf[i >> 3] |= uint8_t(0x80 >> (i & 7));
      else buf[i >> 3] &= uint8_t(~(0x80 >> (i & 7)));
    }
    x += slot;
  };
  for (; runs < erun; runs += 2) {
    paint(runs[0], false);
    paint(runs[1], true);
  }
}

struct Overflow {};  // libtiff's "Buffer overflow": the strip fails

struct Decoder {
  const uint8_t* p;
  size_t n, pos = 0;
  uint32_t acc = 0;  // BitAcc
  int avail = 0;     // BitsAvail
  int eolcnt = 0;
  int lastx;
  uint32_t nruns;
  std::vector<uint32_t> store;
  uint32_t *cur, *ref;
  // the row being decoded (DECLARE_STATE's locals)
  int a0 = 0, run_length = 0, b1 = 0;
  uint32_t *pa = nullptr, *thisrun = nullptr, *pb = nullptr;
  const Ent* ent = nullptr;

  Decoder(const uint8_t* data, size_t size, int64_t width, bool two_d) : p(data), n(size), lastx(int(width)) {
    const uint32_t r = (uint32_t(width) + 1 + 31) / 32 * 32;  // TIFFroundup_32(rowpixels + 1, 32)
    nruns = two_d ? 2 * r : r;
    store.assign(size_t(2) * nruns, 0);
    cur = store.data();
    ref = two_d ? store.data() + nruns : nullptr;
    if (ref) ref[0] = uint32_t(width), ref[1] = 0;  // the reference line above the first row: white
  }

  // NeedBits8 / NeedBits16: false at the end of the data with no bit left;
  // a partial code is padded with zeros.
  bool need(int k) {
    while (avail < k) {
      if (pos >= n) {
        if (avail == 0) return false;
        avail = k;
        break;
      }
      acc |= uint32_t(rev8(p[pos++])) << avail;
      avail += 8;
    }
    return true;
  }
  uint32_t bits(int k) const { return acc & ((1u << k) - 1); }
  void clr(int k) { avail -= k, acc >>= k; }
  bool lookup(const Ent* table, int k) {
    if (!need(k)) return false;
    ent = table + bits(k);
    clr(ent->width);
    return true;
  }
  void setvalue(uint32_t x) {
    if (pa >= thisrun + nruns) throw Overflow{};
    *pa++ = uint32_t(run_length) + x;
    a0 += int(x);
    run_length = 0;
  }
  void cleanup_runs() {  // CLEANUP_RUNS
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= int(*--pa);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(uint32_t(lastx - a0));
      } else if (a0 > lastx) {
        setvalue(uint32_t(lastx));
        setvalue(0);
      }
    }
  }
  // SYNC_EOL: skip to the bit after the next EOL.  Where the data ends
  // before one, libtiff 4.7 tries the strip as T.4 data without EOLs ("Try
  // to decode (read) fax Group 3 data without EOL"): it reads the strip
  // again from its first bit and no longer looks for EOLs, in this strip
  // or any later one.
  bool no_eol = false;
  void sync_eol() {
    if (no_eol) return;
    if (eolcnt == 0) {
      for (;;) {
        if (!need(11)) return restart_without_eol();
        if (bits(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need(8)) return restart_without_eol();
      if (bits(8)) break;
      clr(8);
    }
    while (bits(1) == 0) clr(1);
    clr(1);
    eolcnt = 0;
  }
  void restart_without_eol() {
    no_eol = true;
    pos = 0, acc = 0, avail = 0, eolcnt = 0;
  }

  enum Result { kDone, kEof };

  // One colour's run (make-up codes then a terminating code) of `table`;
  // kDone with `bad` set if a code word is not one of that colour's.
  Result colour_run(const Ent* table, int k, int term, int makeup, bool& bad, bool& eol) {
    for (;;) {
      if (!lookup(table, k)) return kEof;
      const int s = ent->state;
      if (s == S_EOL && eol) {
        eolcnt = 1;
        bad = true;
        return kDone;
      }
      if (s == term) {
        setvalue(ent->param);
        return kDone;
      }
      if (s == makeup || s == S_MakeUp) {
        a0 += int(ent->param);
        run_length += int(ent->param);
        continue;
      }
      eol = false;
      bad = true;
      return kDone;
    }
  }

  // EXPAND1D: white and black runs until the row is full, an EOL or a bad
  // code word; then CLEANUP_RUNS.  kEof: the data ended (runs cleaned up).
  Result expand1d() {
    for (;;) {
      bool bad = false, eol = true;
      if (colour_run(tables().white, 12, S_TermW, S_MakeUpW, bad, eol) == kEof) break;
      if (bad || a0 >= lastx) return cleanup_runs(), kDone;
      eol = true;
      if (colour_run(tables().black, 13, S_TermB, S_MakeUpB, bad, eol) == kEof) break;
      if (bad || a0 >= lastx) return cleanup_runs(), kDone;
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
    }
    cleanup_runs();  // premature EOF
    return kEof;
  }

  void check_b1() {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= ref + nruns) throw Overflow{};
        b1 += int(pb[0] + pb[1]);
        pb += 2;
      }
  }

  // EXPAND2D against the reference line `ref` (pb, b1 set by the caller).
  Result expand2d() {
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) throw Overflow{};
      if (!lookup(tables().main, 7)) return cleanup_runs(), kEof;
      switch (ent->state) {
        case S_Pass:
          check_b1();
          if (pb + 1 >= ref + nruns) throw Overflow{};
          b1 += int(*pb++);
          run_length += b1 - a0;
          a0 = b1;
          b1 += int(*pb++);
          break;
        case S_Horiz: {
          const bool black_first = (pa - thisrun) & 1;
          for (int half = 0; half < 2; ++half) {
            const bool black = black_first != (half == 1);
            bool bad = false, eol = false;
            if ((black ? colour_run(tables().black, 13, S_TermB, S_MakeUpB, bad, eol)
                       : colour_run(tables().white, 12, S_TermW, S_MakeUpW, bad, eol)) == kEof)
              return cleanup_runs(), kEof;
            if (bad) goto eol2d;
          }
          check_b1();
          break;
        }
        case S_V0:
          check_b1();
          setvalue(uint32_t(b1 - a0));
          if (pb >= ref + nruns) throw Overflow{};
          b1 += int(*pb++);
          break;
        case S_VR:
          check_b1();
          setvalue(uint32_t(b1 - a0 + int(ent->param)));
          if (pb >= ref + nruns) throw Overflow{};
          b1 += int(*pb++);
          break;
        case S_VL:
          check_b1();
          if (b1 < int(a0 + int(ent->param))) goto eol2d;  // "Bad code word"
          setvalue(uint32_t(b1 - a0 - int(ent->param)));
          b1 -= int(*--pb);
          break;
        case S_Ext:  // uncompressed mode: not supported, the row ends
          *pa++ = uint32_t(lastx - a0);
          goto eol2d;
        case S_EOL:
          *pa++ = uint32_t(lastx - a0);
          if (!need(4)) return cleanup_runs(), kEof;
          clr(4);
          eolcnt = 1;
          goto eol2d;
        default:
          goto eol2d;
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {  // expect a final V0
        if (!need(1)) return cleanup_runs(), kEof;
        if (!bits(1)) goto eol2d;
        clr(1);
      }
      setvalue(0);
    }
  eol2d:
    cleanup_runs();
    return kDone;
  }
};

}  // namespace

void decode(const uint8_t* data, size_t n, int compression, int64_t options, int64_t width, int64_t rows,
            size_t row_bytes, size_t offset, bool tile, bool& no_eol, std::vector<uint8_t>& out) {
  out.resize(size_t(rows) * row_bytes, 0);
  const bool two_d = compression == 4 || (compression == 3 && (options & 1));
  Decoder d(data, n, width, two_d);
  d.no_eol = no_eol;
  struct Keep {  // the codec's mode outlives the strip: later strips skip EOLs too
    Decoder& d;
    bool& no_eol;
    ~Keep() { no_eol = d.no_eol; }
  } keep{d, no_eol};
  const uint32_t lastx = uint32_t(width);
  int64_t line = 0;
  // The decoders return -1 on these; TIFFReadEncodedStrip fails then, but
  // TIFFReadEncodedTile tests the result for truth, so a tile stands with
  // the rows decoded so far (the rest as the buffer held them).
  struct Stop {};
  auto fail = [tile](const char* what) -> void {
    if (tile) throw Stop{};
    throw std::runtime_error(what);
  };
  try {
    for (uint8_t* buf = out.data(); line < rows; ++line, buf += row_bytes) {
      d.a0 = 0, d.run_length = 0;
      d.thisrun = d.pa = d.cur;
      if (compression == 2 || compression == 32771) {  // Fax3DecodeRLE
        const auto r = d.expand1d();
        fill_runs(buf, d.thisrun, d.pa, lastx);
        if (r == Decoder::kEof) fail("not enough CCITT RLE data in a TIFF strip or tile");
        if (compression == 2) {
          d.clr(d.avail & 7);
        } else {
          d.clr(d.avail & 15);
          if (d.avail == 0 && ((offset + d.pos) & 1)) ++d.pos;  // the next byte's address, word-aligned
        }
      } else if (compression == 3) {  // Fax3Decode1D / Fax3Decode2D
        Decoder::Result r = Decoder::kEof;
        d.sync_eol();
        if (!two_d) {
          r = d.expand1d();
        } else if (d.need(1)) {
          const bool one_d = d.bits(1);
          d.clr(1);
          d.pb = d.ref;
          d.b1 = int(*d.pb++);
          r = one_d ? d.expand1d() : d.expand2d();
        } else {
          d.cleanup_runs();
        }
        fill_runs(buf, d.thisrun, d.pa, lastx);
        if (r == Decoder::kEof) fail("not enough CCITT Group 3 data in a TIFF strip or tile");
        if (two_d) {
          if (d.pa < d.thisrun + d.nruns) d.setvalue(0);  // an imaginary change for the reference
          std::swap(d.cur, d.ref);
        }
      } else {  // Fax4Decode
        d.pb = d.ref;
        d.b1 = int(*d.pb++);
        const auto r = d.expand2d();
        if (r == Decoder::kEof || d.eolcnt) {  // the strip ends: rows before it stand
          fill_runs(buf, d.thisrun, d.pa, lastx);
          if (line == 0) fail("no CCITT Group 4 data in a TIFF strip or tile");
          break;
        }
        fill_runs(buf, d.thisrun, d.pa, lastx);
        d.setvalue(0);  // an imaginary change for the reference
        std::swap(d.cur, d.ref);
      }
    }
  } catch (const Overflow&) {
    if (!tile) throw std::runtime_error("corrupt CCITT data in a TIFF strip: its runs overflow the row");
  } catch (const Stop&) {
  }
}

}  // namespace fax
