// _seqpack: CPython extension packing a Python list of sequences (str or
// bytes) into a caller-allocated padded uint8 matrix, optionally translating
// every byte through a 256-entry fold LUT in the same pass.
//
// This is the host side of the batch engine's scaling contract: one chip
// fills a 512x512 pair in ~2.5us, so a host feeding 4-8 chips must pack a
// pair in well under 1us.  The numpy path (string join + boolean scatter +
// fold fancy-index) measured ~2.6us/pair at L=512; this extension does one
// translate-copy per row at memcpy speed (GIL released, row-range threaded)
// for ~0.15-0.3us/pair, which is what makes chips_per_host_at_90pct >= 4 in
// SCALING.json (the reference has no batching at all: pairs are aligned
// serially in a callback loop, the reference's src/alignment_cmdline.c:611-622).
//
// No numpy C API: the caller passes raw output addresses (arr.ctypes.data)
// of arrays it owns; phase 1 walks the Python list under the GIL collecting
// (ptr, len) views, phase 2 copies without the GIL.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct View {
    const uint8_t *ptr;
    int64_t len;
};

// Persistent worker pool: thread spawn costs ~20-40us, which at the
// 100-300us batch sizes the engine packs would eat most of the win.
// Workers live for the process; run_parallel fans a [0, n) range out as
// `nsplit` contiguous chunks (the caller's thread takes the first).
class Pool {
  public:
    static Pool &get() {
        // leaked deliberately: joining/destroying workers during static
        // teardown would std::terminate
        static Pool *p = new Pool();
        return *p;
    }

    void run_parallel(int nsplit, int64_t n,
                      const std::function<void(int64_t, int64_t)> &fn) {
        if (nsplit <= 1 || n < nsplit) {
            fn(0, n);
            return;
        }
        int helpers = nsplit - 1;
        int64_t per = (n + nsplit - 1) / nsplit;
        {
            std::unique_lock<std::mutex> lk(mu_);
            task_ = &fn;
            task_n_ = n;
            task_per_ = per;
            pending_ = helpers;
            done_ = 0;
            ++gen_;
            cv_.notify_all();
        }
        fn(0, per < n ? per : n);  // chunk 0 on the calling thread
        std::unique_lock<std::mutex> lk(mu_);
        cv_done_.wait(lk, [&] { return done_ == helpers; });
        task_ = nullptr;
    }

  private:
    Pool() {
        int n = (int)std::thread::hardware_concurrency();
        if (n < 2) n = 2;
        if (n > 4) n = 4;
        for (int i = 1; i < n; ++i)
            workers_.emplace_back([this, i] { worker(i); });
        nworkers_ = n - 1;
    }

    void worker(int idx) {
        uint64_t seen = 0;
        for (;;) {
            const std::function<void(int64_t, int64_t)> *task;
            int64_t lo, hi;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [&] { return gen_ != seen && task_; });
                seen = gen_;
                if (idx > pending_) continue;  // more workers than chunks
                task = task_;
                lo = idx * task_per_;
                hi = lo + task_per_;
                if (hi > task_n_) hi = task_n_;
            }
            if (lo < hi) (*task)(lo, hi);
            {
                std::unique_lock<std::mutex> lk(mu_);
                ++done_;
                cv_done_.notify_one();
            }
        }
    }

  public:
    int nworkers_ = 0;

  private:
    std::vector<std::thread> workers_;
    std::mutex mu_;
    std::condition_variable cv_, cv_done_;
    const std::function<void(int64_t, int64_t)> *task_ = nullptr;
    int64_t task_n_ = 0, task_per_ = 0;
    int pending_ = 0, done_ = 0;
    uint64_t gen_ = 0;
};

// Fold specializations: every shipped scoring config's fold table is
// either identity (case-sensitive) or ASCII tolower — both admit
// SIMD-friendly loops (~5-10x the byte-LUT translate).  Arbitrary
// tables keep the general loop.
enum FoldKind { FOLD_NONE, FOLD_TOLOWER, FOLD_TABLE };

FoldKind classify_fold(const uint8_t *fold) {
    if (!fold) return FOLD_NONE;
    bool ident = true, lower = true;
    for (int c = 0; c < 256; ++c) {
        uint8_t lo = (c >= 'A' && c <= 'Z') ? (uint8_t)(c + 32) : (uint8_t)c;
        if (fold[c] != (uint8_t)c) ident = false;
        if (fold[c] != lo) lower = false;
    }
    if (ident) return FOLD_NONE;
    return lower ? FOLD_TOLOWER : FOLD_TABLE;
}

inline void tolower_copy(uint8_t *dst, const uint8_t *src, int64_t n) {
    // branchless: auto-vectorizes under -O3 (cmp + masked add)
    for (int64_t k = 0; k < n; ++k) {
        uint8_t c = src[k];
        dst[k] = (uint8_t)(c + (((uint8_t)(c - 'A') < 26) ? 32 : 0));
    }
}

// translate-copy rows [r0, r1) into out (row stride L); tails pad with
// the FOLDED zero byte (the numpy reference folds after padding, so the
// pad value is fold[0] — 0 for every identity/tolower production fold)
void copy_rows(const std::vector<View> &views, int64_t r0, int64_t r1,
               int64_t L, const uint8_t *fold, FoldKind kind,
               uint8_t *out) {
    const uint8_t padb = fold ? fold[0] : 0;
    for (int64_t i = r0; i < r1; ++i) {
        uint8_t *dst = out + i * L;
        const View &v = views[i];
        if (kind == FOLD_TABLE) {
            for (int64_t k = 0; k < v.len; ++k) dst[k] = fold[v.ptr[k]];
        } else if (kind == FOLD_TOLOWER) {
            tolower_copy(dst, v.ptr, v.len);
        } else if (v.len) {
            std::memcpy(dst, v.ptr, (size_t)v.len);
        }
        if (v.len < L)
            std::memset(dst + v.len, padb, (size_t)(L - v.len));
    }
}

// pack_into(seqs, out_addr, L, fold_addr, lens_addr) -> None
//   seqs: list of str (1-byte kind only) / bytes / bytearray
//   out_addr: uint8[len(seqs) * L], row-major, caller-owned
//   L: row width; every sequence must have len <= L
//   fold_addr: uint8[256] translate table address, or 0 for raw copy
//   lens_addr: int32[len(seqs)] output lengths, caller-owned
// Raises ValueError for unsupported str kinds / overlong rows so callers
// can fall back to the numpy path.
PyObject *pack_into(PyObject *, PyObject *args) {
    PyObject *seqs;
    unsigned long long out_addr, fold_addr, lens_addr;
    long long L;
    if (!PyArg_ParseTuple(args, "OKLKK", &seqs, &out_addr, &L, &fold_addr,
                          &lens_addr))
        return nullptr;
    if (!PyList_Check(seqs)) {
        PyErr_SetString(PyExc_TypeError, "seqs must be a list");
        return nullptr;
    }
    const Py_ssize_t n = PyList_GET_SIZE(seqs);
    auto *out = reinterpret_cast<uint8_t *>(out_addr);
    auto *fold = reinterpret_cast<const uint8_t *>(fold_addr);
    auto *lens = reinterpret_cast<int32_t *>(lens_addr);

    std::vector<View> views((size_t)n);
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject *s = PyList_GET_ITEM(seqs, i);
        const uint8_t *p;
        int64_t m;
        if (PyUnicode_Check(s)) {
            if (PyUnicode_KIND(s) != PyUnicode_1BYTE_KIND) {
                // non-latin-1 chars: the numpy path raises the same way
                // via .encode("latin-1") — signal fallback
                PyErr_SetString(PyExc_ValueError,
                                "seqpack: non-latin-1 string");
                return nullptr;
            }
            p = reinterpret_cast<const uint8_t *>(PyUnicode_1BYTE_DATA(s));
            m = (int64_t)PyUnicode_GET_LENGTH(s);
        } else if (PyBytes_Check(s)) {
            p = reinterpret_cast<const uint8_t *>(PyBytes_AS_STRING(s));
            m = (int64_t)PyBytes_GET_SIZE(s);
        } else if (PyByteArray_Check(s)) {
            p = reinterpret_cast<const uint8_t *>(PyByteArray_AS_STRING(s));
            m = (int64_t)PyByteArray_GET_SIZE(s);
        } else {
            PyErr_SetString(PyExc_ValueError, "seqpack: unsupported type");
            return nullptr;
        }
        if (m > L) {
            PyErr_SetString(PyExc_ValueError, "seqpack: row longer than L");
            return nullptr;
        }
        views[(size_t)i] = {p, m};
        lens[i] = (int32_t)m;
    }

    Py_BEGIN_ALLOW_THREADS;
    const int64_t total = (int64_t)n * L;
    Pool &pool = Pool::get();
    // pool wakeup costs ~30-50us under contention: only fan out when
    // each helper saves more than that (~256KB+ of translate-copy)
    int nsplit = total >= (1 << 20) ? pool.nworkers_ + 1
                                    : (total >= (1 << 18) ? 2 : 1);
    if (nsplit > pool.nworkers_ + 1) nsplit = pool.nworkers_ + 1;
    FoldKind kind = classify_fold(fold);
    pool.run_parallel(nsplit, n, [&](int64_t r0, int64_t r1) {
        copy_rows(views, r0, r1, L, fold, kind, out);
    });
    Py_END_ALLOW_THREADS;
    Py_RETURN_NONE;
}

// lens_into(seqs, lens_addr) -> None: int32 lengths of a list of
// str/bytes/bytearray (the routing pass the engine runs before packing —
// numpy fromiter costs ~80ns/element in Python, this ~10ns)
PyObject *lens_into(PyObject *, PyObject *args) {
    PyObject *seqs;
    unsigned long long lens_addr;
    if (!PyArg_ParseTuple(args, "OK", &seqs, &lens_addr)) return nullptr;
    if (!PyList_Check(seqs)) {
        PyErr_SetString(PyExc_TypeError, "seqs must be a list");
        return nullptr;
    }
    const Py_ssize_t n = PyList_GET_SIZE(seqs);
    auto *lens = reinterpret_cast<int32_t *>(lens_addr);
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject *s = PyList_GET_ITEM(seqs, i);
        Py_ssize_t m;
        if (PyUnicode_Check(s))
            m = PyUnicode_GET_LENGTH(s);
        else if (PyBytes_Check(s))
            m = PyBytes_GET_SIZE(s);
        else if (PyByteArray_Check(s))
            m = PyByteArray_GET_SIZE(s);
        else {
            PyErr_SetString(PyExc_ValueError, "seqpack: unsupported type");
            return nullptr;
        }
        lens[i] = (int32_t)m;
    }
    Py_RETURN_NONE;
}

// fold_into(src_addr, dst_addr, nbytes, fold_addr) -> None
//   contiguous uint8 translate (dst may equal src), threaded for big blocks;
//   the array-level analog of pack_into's fold for callers that already
//   hold padded byte matrices (ops.dp.compact_inputs_mm).
PyObject *fold_into(PyObject *, PyObject *args) {
    unsigned long long src_addr, dst_addr, fold_addr;
    long long nbytes;
    if (!PyArg_ParseTuple(args, "KKLK", &src_addr, &dst_addr, &nbytes,
                          &fold_addr))
        return nullptr;
    auto *src = reinterpret_cast<const uint8_t *>(src_addr);
    auto *dst = reinterpret_cast<uint8_t *>(dst_addr);
    auto *fold = reinterpret_cast<const uint8_t *>(fold_addr);
    Py_BEGIN_ALLOW_THREADS;
    Pool &pool = Pool::get();
    int nsplit = nbytes >= (1 << 20) ? pool.nworkers_ + 1
                                     : (nbytes >= (1 << 18) ? 2 : 1);
    if (nsplit > pool.nworkers_ + 1) nsplit = pool.nworkers_ + 1;
    FoldKind kind = classify_fold(fold);
    pool.run_parallel(nsplit, nbytes, [&](int64_t lo, int64_t hi) {
        if (kind == FOLD_TOLOWER) {
            tolower_copy(dst + lo, src + lo, hi - lo);
        } else if (kind == FOLD_NONE) {
            std::memcpy(dst + lo, src + lo, (size_t)(hi - lo));
        } else {
            for (int64_t k = lo; k < hi; ++k) dst[k] = fold[src[k]];
        }
    });
    Py_END_ALLOW_THREADS;
    Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"pack_into", pack_into, METH_VARARGS,
     "pack_into(seqs, out_addr, L, fold_addr, lens_addr)"},
    {"fold_into", fold_into, METH_VARARGS,
     "fold_into(src_addr, dst_addr, nbytes, fold_addr)"},
    {"lens_into", lens_into, METH_VARARGS, "lens_into(seqs, lens_addr)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moddef = {
    PyModuleDef_HEAD_INIT, "_seqpack",
    "native batch packer (see seqalign_tpu_torch.io.packer)", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__seqpack(void) { return PyModule_Create(&moddef); }
