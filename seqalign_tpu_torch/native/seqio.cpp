// Native sequence reader — C++ equivalent of the reference's bundled
// seq_file submodule (L1a): streaming FASTA/FASTQ/plain/SAM/BAM records
// (format surface per reference README.md:28) with transparent gzip,
// exposed through a C ABI consumed via ctypes (seqalign_tpu_torch/io/native.py).
// Semantics mirror seqalign_tpu_torch/io/seqio.py (which mirrors the call-site
// contract in alignment_cmdline.c:570-640).
//
// Batch-oriented API: records are returned in blocks of packed bytes +
// offsets so the Python side does one ctypes call per thousands of
// records, not per record.

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Mode { UNDECIDED = -1, TEXT = 0, SAM = 1, BAM = 2 };

// BAM 4-bit base codes (SAM spec section 4.2.3)
const char kBamBases[] = "=ACMGRSVTWYHKDBN";

struct Reader {
  gzFile gz = nullptr;
  std::string pushbuf;  // pushed-back bytes, consumed front-first
  size_t push_pos = 0;
  int mode = UNDECIDED;
  bool bam_header_done = false;
  // block staging buffers
  std::vector<char> seq_bytes;
  std::vector<char> name_bytes;
  std::vector<int64_t> seq_offsets;   // n+1 offsets
  std::vector<int64_t> name_offsets;  // n+1 offsets; -1 len => no name
  std::vector<int8_t> has_name;
};

int rd_getc(Reader* r) {
  if (r->push_pos < r->pushbuf.size()) {
    return static_cast<unsigned char>(r->pushbuf[r->push_pos++]);
  }
  return gzgetc(r->gz);
}

// prepend bytes to be re-read before anything else
void rd_unread(Reader* r, const std::string& s) {
  r->pushbuf = s + r->pushbuf.substr(r->push_pos);
  r->push_pos = 0;
}

// read exactly n bytes; returns count actually read
size_t rd_bytes(Reader* r, char* out, size_t n) {
  size_t i = 0;
  while (i < n && r->push_pos < r->pushbuf.size()) {
    out[i++] = r->pushbuf[r->push_pos++];
  }
  if (i < n) {
    int got = gzread(r->gz, out + i, static_cast<unsigned>(n - i));
    if (got > 0) i += static_cast<size_t>(got);
  }
  return i;
}

int32_t rd_i32le(Reader* r, bool* ok) {
  unsigned char b[4];
  if (rd_bytes(r, reinterpret_cast<char*>(b), 4) != 4) {
    *ok = false;
    return 0;
  }
  *ok = true;
  return static_cast<int32_t>(static_cast<uint32_t>(b[0]) |
                              (static_cast<uint32_t>(b[1]) << 8) |
                              (static_cast<uint32_t>(b[2]) << 16) |
                              (static_cast<uint32_t>(b[3]) << 24));
}

// read one line (no newline, \r stripped) into out; returns false at EOF
// with nothing read
bool rd_line(Reader* r, std::string* out) {
  out->clear();
  int c;
  bool any = false;
  while ((c = rd_getc(r)) != -1) {
    any = true;
    if (c == '\n') return true;
    if (c != '\r') out->push_back(static_cast<char>(c));
  }
  return any;
}

void rd_split_tabs(const std::string& line, std::vector<std::string>* out) {
  out->clear();
  size_t start = 0;
  while (true) {
    size_t tab = line.find('\t', start);
    if (tab == std::string::npos) {
      out->push_back(line.substr(start));
      return;
    }
    out->push_back(line.substr(start, tab - start));
    start = tab + 1;
  }
}

bool is_all_digits(const std::string& s) {
  if (s.empty()) return false;
  for (char c : s)
    if (c < '0' || c > '9') return false;
  return true;
}

// SAM sniff on the first non-empty line: a header tag, or a headerless
// alignment line (>= 11 tab fields, numeric FLAG/POS/MAPQ) — mirrors
// seqalign_tpu_torch/io/seqio.py::_is_sam_first_line
bool is_sam_first_line(const std::string& ln) {
  static const char* kCodes[] = {"@HD", "@SQ", "@RG", "@PG", "@CO"};
  for (const char* c : kCodes) {
    if (ln.compare(0, 3, c) == 0 && (ln.size() == 3 || ln[3] == '\t'))
      return true;
  }
  if (!ln.empty() && (ln[0] == '>' || ln[0] == '@')) return false;
  std::vector<std::string> f;
  rd_split_tabs(ln, &f);
  return f.size() >= 11 && is_all_digits(f[1]) && is_all_digits(f[3]) &&
         is_all_digits(f[4]);
}

bool rd_line(Reader* r, std::string* out);

// decide TEXT / SAM / BAM from the stream head, re-reading nothing
void rd_sniff(Reader* r) {
  char magic[4];
  size_t got = rd_bytes(r, magic, 4);
  if (got == 4 && std::memcmp(magic, "BAM\1", 4) == 0) {
    r->mode = BAM;
    return;
  }
  rd_unread(r, std::string(magic, got));
  std::string line;
  bool any = false;
  while ((any = rd_line(r, &line)) && line.empty()) {
  }
  if (!any) {
    r->mode = TEXT;
    return;
  }
  r->mode = is_sam_first_line(line) ? SAM : TEXT;
  rd_unread(r, line + "\n");
}

int rd_record_sam(Reader* r, std::string* name, bool* named,
                  std::string* seq) {
  std::string line;
  std::vector<std::string> f;
  while (rd_line(r, &line)) {
    if (line.empty() || line[0] == '@') continue;
    rd_split_tabs(line, &f);
    if (f.size() < 11) continue;
    *name = f[0];
    *named = true;
    if (f[9] != "*") *seq = f[9];
    return 1;
  }
  return 0;
}

bool rd_skip(Reader* r, size_t n) {
  char buf[4096];
  while (n > 0) {
    size_t take = n < sizeof(buf) ? n : sizeof(buf);
    if (rd_bytes(r, buf, take) != take) return false;
    n -= take;
  }
  return true;
}

int rd_record_bam(Reader* r, std::string* name, bool* named,
                  std::string* seq) {
  bool ok;
  if (!r->bam_header_done) {
    int32_t l_text = rd_i32le(r, &ok);
    if (!ok || !rd_skip(r, static_cast<size_t>(l_text))) return 0;
    int32_t n_ref = rd_i32le(r, &ok);
    if (!ok) return 0;
    for (int32_t i = 0; i < n_ref; i++) {
      int32_t l_name = rd_i32le(r, &ok);
      if (!ok || !rd_skip(r, static_cast<size_t>(l_name) + 4)) return 0;
    }
    r->bam_header_done = true;
  }
  int32_t block_size = rd_i32le(r, &ok);
  if (!ok || block_size < 32) return 0;
  std::vector<char> rec(static_cast<size_t>(block_size));
  if (rd_bytes(r, rec.data(), rec.size()) != rec.size()) return 0;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(rec.data());
  unsigned l_read_name = p[8];
  unsigned n_cigar = static_cast<unsigned>(p[12]) |
                     (static_cast<unsigned>(p[13]) << 8);
  int32_t l_seq = static_cast<int32_t>(
      static_cast<uint32_t>(p[16]) | (static_cast<uint32_t>(p[17]) << 8) |
      (static_cast<uint32_t>(p[18]) << 16) |
      (static_cast<uint32_t>(p[19]) << 24));
  size_t off = 32;
  if (off + l_read_name > rec.size()) return 0;
  name->assign(rec.data() + off, l_read_name > 0 ? l_read_name - 1 : 0);
  *named = true;
  off += l_read_name + 4 * static_cast<size_t>(n_cigar);
  size_t nbytes = (static_cast<size_t>(l_seq) + 1) / 2;
  if (off + nbytes > rec.size()) return 0;
  seq->reserve(static_cast<size_t>(l_seq));
  for (int32_t i = 0; i < l_seq; i++) {
    unsigned char b = p[off + (i >> 1)];
    seq->push_back(kBamBases[(i & 1) == 0 ? (b >> 4) : (b & 0xF)]);
  }
  return 1;
}

// Read one record. Returns: 1 = record, 0 = EOF.
int rd_record(Reader* r, std::string* name, bool* named, std::string* seq) {
  name->clear();
  seq->clear();
  *named = false;
  if (r->mode == UNDECIDED) rd_sniff(r);
  if (r->mode == SAM) return rd_record_sam(r, name, named, seq);
  if (r->mode == BAM) return rd_record_bam(r, name, named, seq);
  int c;
  while ((c = rd_getc(r)) != -1 && (c == '\n' || c == '\r')) {
  }
  if (c == -1) return 0;
  if (c == '>') {
    rd_line(r, name);
    *named = true;
    std::string line;
    while ((c = rd_getc(r)) != -1) {
      if (c == '>' || c == '@') {
        rd_unread(r, std::string(1, static_cast<char>(c)));
        break;
      }
      if (c == '\n' || c == '\r') continue;
      seq->push_back(static_cast<char>(c));
      while ((c = rd_getc(r)) != -1 && c != '\n')
        if (c != '\r') seq->push_back(static_cast<char>(c));
      if (c == -1) break;
    }
    return 1;
  }
  if (c == '@') {
    rd_line(r, name);
    *named = true;
    rd_line(r, seq);
    std::string skip;
    rd_line(r, &skip);  // '+'
    rd_line(r, &skip);  // quals
    return 1;
  }
  // plain line
  seq->push_back(static_cast<char>(c));
  while ((c = rd_getc(r)) != -1 && c != '\n')
    if (c != '\r') seq->push_back(static_cast<char>(c));
  return 1;
}

}  // namespace

extern "C" {

void* seqio_open(const char* path) {
  gzFile gz = std::strcmp(path, "-") == 0 ? gzdopen(0, "r") : gzopen(path, "r");
  if (gz == nullptr) return nullptr;
  auto* r = new Reader();
  r->gz = gz;
  return r;
}

void seqio_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  gzclose(r->gz);
  delete r;
}

// Read up to max_records records into the handle's staging buffers.
// Returns the number of records read (0 at EOF).
int64_t seqio_read_block(void* h, int64_t max_records) {
  auto* r = static_cast<Reader*>(h);
  r->seq_bytes.clear();
  r->name_bytes.clear();
  r->seq_offsets.assign(1, 0);
  r->name_offsets.assign(1, 0);
  r->has_name.clear();
  std::string name, seq;
  bool named;
  int64_t n = 0;
  while (n < max_records && rd_record(r, &name, &named, &seq) == 1) {
    r->seq_bytes.insert(r->seq_bytes.end(), seq.begin(), seq.end());
    r->seq_offsets.push_back(static_cast<int64_t>(r->seq_bytes.size()));
    r->name_bytes.insert(r->name_bytes.end(), name.begin(), name.end());
    r->name_offsets.push_back(static_cast<int64_t>(r->name_bytes.size()));
    r->has_name.push_back(named ? 1 : 0);
    n++;
  }
  return n;
}

// Accessors for the staged block (valid until the next read_block call).
const char* seqio_seq_bytes(void* h) {
  return static_cast<Reader*>(h)->seq_bytes.data();
}
const int64_t* seqio_seq_offsets(void* h) {
  return static_cast<Reader*>(h)->seq_offsets.data();
}
const char* seqio_name_bytes(void* h) {
  return static_cast<Reader*>(h)->name_bytes.data();
}
const int64_t* seqio_name_offsets(void* h) {
  return static_cast<Reader*>(h)->name_offsets.data();
}
const int8_t* seqio_has_name(void* h) {
  return static_cast<Reader*>(h)->has_name.data();
}

}  // extern "C"
