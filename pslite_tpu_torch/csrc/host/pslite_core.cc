// pslite_core — native transport core for pslite_tpu.
//
// TPU-native counterpart of the reference's C++ Van layer hot path
// (src/zmq_van.h + src/van.cc framing): an epoll-driven TCP transport that
// frames messages with the shared wire format
//
//   u32 magic | u32 meta_len | u32 n_data | u64 data_len[n_data] | meta | data…
//
// (see pslite_tpu/wire.py — the Python and C++ sides interoperate on the
// byte level).  Socket IO, frame assembly, and the receive queue run on
// native threads with no GIL involvement; Python drives it through the
// C API below via ctypes.
//
// Build: make -C cpp   ->  cpp/libpslite_core.so
//
// pslite_tpu_torch: this file is the port's own copy of cpp/pslite_core.cc
// (the port loads nothing of the JAX package).  pslite_tpu_torch/vans/
// native.py builds it with g++ at first use into pslite_tpu_torch/_build/
// (-fvisibility=hidden) and checks kAbiVersion against its ABI_VERSION.
// Every change from the JAX package's copy is marked "pslite_tpu_torch:".

#include <arpa/inet.h>
#include <dirent.h>
#include <pthread.h>
#include <fcntl.h>
#include <netdb.h>
#include <poll.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <sys/un.h>
#include <unistd.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <cmath>
#if defined(__x86_64__)
#include <immintrin.h>
#include <cpuid.h>
#endif
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
// pslite_tpu_torch: std::function (CodecSpanPool), which g++ 12's
// headers do not bring in through the others.
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x50535450;  // "PSTP", wire.py MAGIC
constexpr size_t kHeaderSize = 12;       // magic + meta_len + n_data

struct Frame {
  uint8_t* buf = nullptr;  // lens + meta + data, one allocation
  uint32_t meta_len = 0;
  uint32_t n_data = 0;
  // Offsets into buf:
  //   [0, 8*n_data)                 data lens
  //   [8*n_data, 8*n_data+meta_len) meta
  //   then data segments back to back
};

// ABI stamp: bumped whenever the C API surface changes so a stale .so
// (make -C cpp not rerun after a source update) is rejected LOUDLY at
// load time instead of silently falling back per-symbol.  Must match
// pslite_tpu/vans/native.py ABI_VERSION.
// 7: cross-rail direct-read reassembly — tcp_van no longer clamps
// PS_NATIVE_REASSEMBLY to a single rail, so a pre-7 (per-connection
// reassembly) library would wait forever for the other rails' stripes.
// 8: fused wire-codec kernels (psl_codec_encode/decode + the fp8 table
// registration) backing the quantized transport tier
// (docs/compression.md).
// 9: wire-plane observatory — per-core syscall/frame/byte counters
// exported through the one-struct psl_stats_snapshot call
// (docs/observability.md): a pre-9 library would leave the native
// lanes dark while Python reports them instrumented.
constexpr int kAbiVersion = 9;

// Fixed offsets inside the python wire format's meta block (wire.py
// _META_FIXED, little-endian, no padding): enough to peek a frame's
// send priority and control command for the express receive lane, and
// to stamp the per-peer sid at transmit time, without decoding the
// meta.  Keep in sync with wire.py (META_*_OFF constants).
constexpr size_t kMetaSidOff = 58;       // i32, stamped at lane dispatch
constexpr size_t kMetaPriorityOff = 70;  // i32
constexpr size_t kMetaControlCmdOff = 84;  // u8; 0 == EMPTY (data plane)
constexpr size_t kMetaFixedSize = 105;

// EXT_CHUNK payload layout (wire.py _EXT_CHUNK_FIXED "<QIIQB"): the
// native chunk splitter patches the per-chunk index and byte offset in
// place; everything else in the template meta is shared by every chunk
// of one transfer.
constexpr size_t kChunkIndexOff = 8;   // u32 within the ext payload
constexpr size_t kChunkTotalOff = 12;  // u32 within the ext payload
constexpr size_t kChunkOffsetOff = 16;  // u64 within the ext payload
constexpr size_t kChunkNsegOff = 24;   // u8 within the ext payload
constexpr size_t kChunkFixedSize = 25;
constexpr size_t kChunkSegEntry = 9;   // u64 len + u8 dtype code

// More fixed meta offsets (wire.py _META_FIXED) used by the native
// receive-side reassembly: sender id, and the variable-tail counters
// needed to locate the extension blocks after the (empty) node list.
constexpr size_t kMetaSenderOff = 17;     // i32
constexpr size_t kMetaNumNodesOff = 97;   // u16
constexpr size_t kMetaNumDtypesOff = 99;  // u16
constexpr size_t kMetaBodyLenOff = 101;   // u32
constexpr uint8_t kExtChunkTag = 2;       // wire.py EXT_CHUNK

// ChunkInfo.index sentinel stamped on a NATIVELY-REASSEMBLED frame:
// the payload is the COMPLETE transfer (original segments, original
// lens table) and Python finalizes the message without touching its
// ChunkAssembler.  Never produced by any sender, so it cannot collide
// with a real chunk index (senders cap transfers far below 2^32).
constexpr uint32_t kChunkCompleteIndex = 0xFFFFFFFFu;

// Wire-plane counter block (docs/observability.md): one POD struct of
// relaxed monotonic totals, snapshotted whole by psl_stats_snapshot so
// the Python side folds the native plane into the metrics registry as
// deltas with a single FFI call.  Layout is ABI-guarded: the abi field
// echoes kAbiVersion and the struct only ever grows at the end.
struct psl_wire_stats {
  uint64_t abi;
  uint64_t tx_syscalls;    // writev calls (socket path; pipes cost 0)
  uint64_t tx_frames;      // frames fully written (chunks individually)
  uint64_t tx_chunks;      // chunk frames from the native splitter
  uint64_t tx_bytes;       // wire bytes out (header+lens+meta+payload)
  uint64_t tx_msgs;        // logical sends completed clean (sync sends
                           // + lane descriptors)
  uint64_t rx_syscalls;    // read calls (socket pumps; pipes cost 0)
  uint64_t rx_frames;      // frames delivered to the recv queue
  uint64_t rx_bytes_copy;  // bytes staged into pool blocks / pipe ring
  uint64_t rx_bytes_zc;    // bytes scatter-read straight into transfer
                           // buffers (direct-read reassembly)
  uint64_t rx_pool_hits;   // frame blocks recycled from the pool
  uint64_t rx_pool_misses; // frame blocks freshly malloc'd
};

// True when this frame rides the express receive lane, mirroring the
// pure-Python PriorityRecvQueue discipline (utils/queues.py,
// docs/chunking.md): control frames (ACKs, heartbeats, barriers) ride
// above EVERY data level so a bulk chunk backlog can never starve the
// control plane, and priority>0 data bypasses the backlog too.
// TERMINATE stays in the ordinary queue — it must drain BEHIND queued
// traffic, or the receive loop would retire with frames undelivered.
static bool FrameIsExpress(const Frame& f) {
  if (f.meta_len < kMetaFixedSize) return false;
  const uint8_t* meta = f.buf + 8ull * f.n_data;
  uint8_t cmd = meta[kMetaControlCmdOff];
  if (cmd != 0) return cmd != 1;  // 1 == TERMINATE (message.py Command)
  int32_t prio;
  memcpy(&prio, meta + kMetaPriorityOff, sizeof(prio));
  return prio > 0;
}

// Cross-process SPSC byte pipe over a /dev/shm mapping — the reference's
// vendored in-process lock-free SPSC ring (spsc_queue.h) extended across
// processes for same-host meta traffic.  Stream semantics: the writer
// copies frame bytes in as space allows, the reader pumps them through
// the same reassembly state machine as a TCP stream, so a pipe is a
// drop-in replacement for the socket between two co-located nodes.
struct PipeHdr {
  uint32_t magic;  // kPipeMagic
  uint32_t pad;
  uint64_t size;  // data-region bytes
  alignas(64) std::atomic<uint64_t> head;  // consumed; reader-owned
  alignas(64) std::atomic<uint64_t> tail;  // produced; writer-owned
  // Reader-liveness heartbeat: CLOCK_MONOTONIC ms, stamped by the reader
  // at attach and on every liveness tick.  Comparable across processes
  // (same host by construction).  0 = no reader has ever attached.  The
  // writer probes it on ring-full waits: a full ring whose reader is not
  // beating means frames are streaming into the void (reader died,
  // desynced+blacklisted, or never enabled PS_SHM_RING) — the writer
  // retires the pipe and falls back to the socket instead of blocking
  // forever once the ring fills.
  alignas(64) std::atomic<uint64_t> reader_beat;
};

// "PSRC" — bumped from "PSRB" when reader_beat joined the header: an
// old-binary reader would otherwise attach cleanly, drain frames, and
// never heartbeat, which a new writer reads as "no reader" and falsely
// retires the pipe.  Mixed versions now refuse to pair instead.
constexpr uint32_t kPipeMagic = 0x50535243;
constexpr size_t kPipeDataOff = 4096;        // header page

struct WritePipe {
  PipeHdr* hdr = nullptr;
  uint8_t* data = nullptr;
  int fd = -1;  // holds LOCK_SH for writer-liveness
  size_t map_len = 0;
  std::string path;
  std::mutex mu;  // in-process senders serialize whole frames
  // Set once the writer declares the reader dead (see PipeHdr::
  // reader_beat); senders bail with -EPIPE and the van falls back to
  // the socket.  The mapping stays alive in a graveyard until shutdown
  // so concurrently-blocked senders never touch freed memory.
  std::atomic<bool> dead{false};
};

// Per-connection frame reassembly state machine.
// Process-global recv-frame buffer pool.  A fresh malloc per frame
// means every received byte lands in never-touched pages, and the soft
// page faults HALVE large-transfer goodput (measured: 64 MiB frames at
// ~6.7 Gbps fresh vs ~18 Gbps into recycled pages on loopback).
// Buffers round up to power-of-two classes and recycle on
// psl_frame_free.  Global and never torn down deliberately: Python
// holds frame views past Core destruction and psl_frame_free carries
// no core handle.  Bounded (PSL_FRAME_POOL_MB, default 256) — blocks
// past the budget free() as before.
class FramePool {
 public:
  static constexpr size_t kHdr = 16;  // capacity stash, keeps 16-align

  static uint8_t* Alloc(size_t n, bool* pool_hit = nullptr) {
    size_t cap = ClassOf(n);
    {
      std::lock_guard<std::mutex> lk(Mu());
      auto& cls = Free()[cap];
      if (!cls.empty()) {
        uint8_t* base = cls.back();
        cls.pop_back();
        Total() -= cap;
        if (pool_hit != nullptr) *pool_hit = true;
        return base + kHdr;
      }
    }
    if (pool_hit != nullptr) *pool_hit = false;
    auto* base = static_cast<uint8_t*>(malloc(cap + kHdr));
    if (base == nullptr) return nullptr;
    memcpy(base, &cap, sizeof(cap));
    return base + kHdr;
  }

  static void Release(uint8_t* p) {
    if (p == nullptr) return;
    uint8_t* base = p - kHdr;
    size_t cap;
    memcpy(&cap, base, sizeof(cap));
    {
      std::lock_guard<std::mutex> lk(Mu());
      if (Total() + cap <= Budget()) {
        Free()[cap].push_back(base);
        Total() += cap;
        return;
      }
    }
    free(base);
  }

 private:
  static size_t ClassOf(size_t n) {
    size_t cap = 4096;
    while (cap < n) cap <<= 1;
    return cap;
  }
  // Function-local statics: safe from any thread, never destroyed
  // before the last psl_frame_free (intentionally leaked at exit).
  static std::mutex& Mu() {
    static std::mutex* mu = new std::mutex();
    return *mu;
  }
  static std::map<size_t, std::vector<uint8_t*>>& Free() {
    static auto* f = new std::map<size_t, std::vector<uint8_t*>>();
    return *f;
  }
  static size_t& Total() {
    static size_t t = 0;
    return t;
  }
  static size_t Budget() {
    static size_t budget = [] {
      const char* v = getenv("PSL_FRAME_POOL_MB");
      long mb = v != nullptr ? atol(v) : 256;
      if (mb < 0) mb = 0;
      return static_cast<size_t>(mb) << 20;
    }();
    return budget;
  }
};

// Receive-side reassembly state of one in-flight chunked transfer
// (native scatter — docs/native_core.md): chunk payloads memcpy
// straight into the final frame body at their byte offset, GIL-free,
// and Python sees ONE complete frame per transfer instead of
// total-chunks pump round trips.
struct ConnXfer {
  uint64_t total_bytes = 0;
  uint32_t total = 0;
  uint32_t got = 0;
  uint32_t nseg = 0;
  uint32_t meta_len = 0;
  size_t body_size = 0;
  uint8_t* buf = nullptr;  // FramePool block: lens | meta | data
  std::vector<bool> received;
  uint64_t seq = 0;  // insertion order, oldest-first eviction
  // Cross-rail direct-read state (Core::xfers_mu_): pumps currently
  // reading a payload into buf hold a reader ref — the entry (and
  // buf) may not be evicted or freed until they finish.  dropped
  // marks an inconsistent transfer whose buffer the LAST reader
  // reclaims.
  int readers = 0;
  bool dropped = false;
};

struct Conn {
  int fd = -1;
  // Stage 0: header; stage 1: lens; stage 2: meta; stage 3: payload.
  // Meta is read BEFORE the payload so a reassembling receiver can
  // parse EXT_CHUNK and point the payload read STRAIGHT at the
  // transfer buffer's byte range (direct-read scatter: the kernel
  // copy-out is the only pass over the data — no intermediate frame
  // buffer, no second memcpy).
  int stage = 0;
  size_t want = kHeaderSize;
  size_t got = 0;
  uint8_t header[kHeaderSize];
  Frame frame;
  size_t body_size = 0;
  // Stage-3 direct-read scatter state (valid while stage == 3 and
  // scatter_dst != nullptr): the payload destination inside the
  // pending transfer's buffer, and the bookkeeping to finish the
  // absorb when the last byte lands.  Same-io-thread only.
  uint8_t* scatter_dst = nullptr;
  bool drop_frame = false;   // consume payload, deliver nothing
  bool dup_chunk = false;    // already-received index: bytes rewrite
  uint32_t pending_index = 0;
  std::pair<long long, unsigned long long> pending_key{0, 0};

  ~Conn() { FramePool::Release(frame.buf); }
};

struct ReadPipe {
  PipeHdr* hdr = nullptr;
  const uint8_t* data = nullptr;
  int fd = -1;
  size_t map_len = 0;
  std::string path;
  Conn conn;  // reassembly state for this byte stream
};

// One queued data-plane send: the meta bytes are COPIED at enqueue (the
// lanes patch sid/chunk fields in place at transmit time); the data
// segments are NOT — they point into Python-owned buffers that the van
// pins until the descriptor's ticket is reaped (docs/native_core.md,
// buffer-ownership rules).
struct SendDesc {
  uint64_t ticket = 0;
  int node_id = 0;
  int priority = 0;
  std::vector<uint8_t> meta;
  std::vector<iovec> data;
  uint64_t total_data = 0;
  // Native chunk split (0 = one monolithic frame): the descriptor
  // transmits as ceil(total_data / chunk_bytes) chunk frames, patching
  // the EXT_CHUNK payload at meta[chunk_ext_off..] per chunk.
  uint64_t chunk_bytes = 0;
  int32_t chunk_ext_off = -1;
  uint32_t next_index = 0;
  uint64_t sent_offset = 0;
  // Multi-rail bookkeeping (lane->mu): chunks of the ACTIVE descriptor
  // are claimed by any rail thread; the descriptor completes (ticket
  // reported, memory freed) only when fully claimed AND no rail is
  // still mid-writev on one of its chunks.
  int inflight = 0;
  bool canceled = false;
  long long error = 0;
};

// Per-peer native send lane: the GIL-free counterpart of the Python
// van's _SendLane (van.py) — highest priority first, FIFO within a
// level, one lazily-spawned sender thread per peer.  Completed tickets
// park in `done` until Python reaps them (releasing its buffer pins).
struct SendLane {
  std::mutex mu;
  std::condition_variable cv;
  std::map<int, std::deque<SendDesc*>, std::greater<int>> q;  // mu
  std::vector<std::pair<uint64_t, long long>> done;           // mu
  // Rail threads (PS_NATIVE_RAILS): rail 0 plus N-1 stripe threads.
  // All rails claim chunks of the ONE active descriptor (strict
  // FIFO-within-level descriptor order; only a strictly-higher
  // priority descriptor overtakes), so per-level transfer order — and
  // with it the server's apply order — matches the single-rail plane.
  std::vector<std::thread> threads;
  SendDesc* active = nullptr;  // mu: descriptor being claimed/transmitted
  // Per-peer data sid, stamped into the meta at CLAIM time under the
  // lane lock so the per-peer sid sequence equals the claim order (the
  // Python lanes' sid-at-dispatch contract; across rails the sids of
  // one transfer's chunks may land interleaved, which every consumer
  // of chunked frames already tolerates).
  std::atomic<int32_t> sid{0};
  bool stop = false;    // mu
  bool drained = false;  // mu: stop-drain ran (first rail to exit does it)
};

class Core {
 public:
  Core() : epfd_(epoll_create1(0)) {}

  ~Core() { StopAndJoin(); }

  int Bind(int port, int backlog) {
    // Non-blocking listener: AcceptAll drains until EAGAIN and must not
    // wedge the io thread.
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (fd < 0) return -errno;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = INADDR_ANY;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
      int err = -errno;
      close(fd);
      return err;
    }
    if (listen(fd, backlog) < 0) {
      int err = -errno;
      close(fd);
      return err;
    }
    socklen_t len = sizeof(addr);
    getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len);
    listen_fd_ = fd;
    StartIo();
    return ntohs(addr.sin_port);
  }

  // DMLC_LOCAL mode: listen on a unix-domain socket instead of TCP
  // (the zmq van's ipc:///tmp/<port> switch, zmq_van.h:107-115).  The
  // caller owns port-number retry; this binds exactly `path`.
  int BindLocal(const char* path, int backlog) {
    sockaddr_un addr{};
    if (strlen(path) >= sizeof(addr.sun_path)) return -ENAMETOOLONG;
    int fd = socket(AF_UNIX, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (fd < 0) return -errno;
    addr.sun_family = AF_UNIX;
    strncpy(addr.sun_path, path, sizeof(addr.sun_path) - 1);
    if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
      int err = -errno;
      close(fd);
      return err;
    }
    if (listen(fd, backlog) < 0) {
      int err = -errno;
      close(fd);
      unlink(path);
      return err;
    }
    bound_path_ = path;
    listen_fd_ = fd;
    StartIo();
    return 0;
  }

  int ConnectLocal(int node_id, const char* path, int timeout_ms) {
    sockaddr_un addr{};
    if (strlen(path) >= sizeof(addr.sun_path)) return -ENAMETOOLONG;
    int fd = socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) return -errno;
    addr.sun_family = AF_UNIX;
    strncpy(addr.sun_path, path, sizeof(addr.sun_path) - 1);
    // Bounded connect, same invariant as the TCP path: a listener with a
    // wedged accept loop and full backlog must not stall forever.
    int flags = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, flags | O_NONBLOCK);
    int rc = connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
    if (rc < 0 && errno == EAGAIN) {
      // AF_UNIX semantics (unix(7)): EAGAIN means the listener's backlog
      // is full and NO connection is in progress — polling would report
      // the unconnected fd writable and fake a success.  Fail now; the
      // caller's retry loop redials.
      close(fd);
      return -EAGAIN;
    }
    if (rc < 0 && errno == EINPROGRESS) {
      pollfd pfd{fd, POLLOUT, 0};
      rc = poll(&pfd, 1, timeout_ms);
      if (rc <= 0) {
        close(fd);
        return rc == 0 ? -ETIMEDOUT : -errno;
      }
      int err = 0;
      socklen_t len = sizeof(err);
      getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len);
      if (err != 0) {
        close(fd);
        return -err;
      }
    } else if (rc < 0) {
      int err = -errno;
      close(fd);
      return err;
    }
    fcntl(fd, F_SETFL, flags);
    std::lock_guard<std::mutex> lk(send_mu_);
    auto it = send_fds_.find(node_id);
    if (it != send_fds_.end()) close(it->second);
    send_fds_[node_id] = fd;
    return 0;
  }

  // -- shm byte pipes (PS_SHM_RING) ---------------------------------------

  // Writer side: create the pipe for (me -> node_id).  Serialized against
  // same-host racers/stale files by an flock on a sibling .lock file; the
  // pipe fd then holds LOCK_SH for the writer's lifetime so readers can
  // probe liveness with LOCK_EX|LOCK_NB.
  int PipeConnect(int node_id, const char* path, uint64_t data_bytes) {
    {
      std::lock_guard<std::mutex> lk(send_mu_);
      auto it = pipes_by_path_.find(path);
      if (it != pipes_by_path_.end()) {
        pipes_[node_id] = it->second;  // re-connect of the same pair
        return 0;
      }
    }
    std::string lockp = std::string(path) + ".lock";
    int lock_fd = open(lockp.c_str(), O_CREAT | O_RDWR, 0600);
    if (lock_fd < 0) return -errno;
    flock(lock_fd, LOCK_EX);
    int rc = PipeCreateLocked(node_id, path, data_bytes);
    flock(lock_fd, LOCK_UN);
    close(lock_fd);
    return rc;
  }

  int PipeCreateLocked(int node_id, const char* path, uint64_t data_bytes) {
    // Reclaim a stale file (writer died): nobody holds LOCK_SH on it.
    int old_fd = open(path, O_RDWR);
    if (old_fd >= 0) {
      if (flock(old_fd, LOCK_EX | LOCK_NB) == 0) {
        unlink(path);
        close(old_fd);
      } else {
        close(old_fd);
        return -EEXIST;  // a live writer owns this name
      }
    }
    int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
    if (fd < 0) return -errno;
    size_t map_len = kPipeDataOff + data_bytes;
    if (ftruncate(fd, static_cast<off_t>(map_len)) < 0) {
      int err = -errno;
      close(fd);
      unlink(path);
      return err;
    }
    void* mem =
        mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    if (mem == MAP_FAILED) {
      int err = -errno;
      close(fd);
      unlink(path);
      return err;
    }
    auto* hdr = new (mem) PipeHdr();
    hdr->size = data_bytes;
    hdr->head.store(0);
    hdr->tail.store(0);
    hdr->magic = kPipeMagic;  // last: readers gate on it
    flock(fd, LOCK_SH);       // writer-liveness token
    auto* p = new WritePipe();
    p->hdr = hdr;
    p->data = static_cast<uint8_t*>(mem) + kPipeDataOff;
    p->fd = fd;
    p->map_len = map_len;
    p->path = path;
    std::lock_guard<std::mutex> lk(send_mu_);
    pipes_[node_id] = p;
    pipes_by_path_[p->path] = p;
    return 0;
  }

  // Take a dead-reader pipe out of service: unroute it (no new senders),
  // release the writer-liveness flock and unlink the name so a redial
  // creates a FRESH pipe (fresh inode — the reader's inode blacklist
  // won't match it), and park the mapping in a graveyard freed at
  // shutdown (a concurrently-blocked sender may still be reading
  // p->hdr; it will see p->dead and bail).  Idempotent under races:
  // only the first retirer acts.
  void RetirePipe(WritePipe* p) {
    bool first = false;
    {
      std::lock_guard<std::mutex> lk(send_mu_);
      // Pointer identity, not path presence: a redial may have already
      // recreated the SAME path as a fresh pipe — erasing by path alone
      // would unroute the new generation and double-park p.
      auto it = pipes_by_path_.find(p->path);
      if (it != pipes_by_path_.end() && it->second == p) {
        pipes_by_path_.erase(it);
        first = true;
      }
      for (auto pit = pipes_.begin(); pit != pipes_.end();) {
        if (pit->second == p) {
          pit = pipes_.erase(pit);
        } else {
          ++pit;
        }
      }
      if (first) dead_write_pipes_.push_back(p);
    }
    if (first) {
      p->dead.store(true, std::memory_order_relaxed);
      close(p->fd);  // releases the writer-liveness LOCK_SH
      p->fd = -1;
      unlink(p->path.c_str());
      fprintf(stderr,
              "[pslite_core] W shm pipe %s: reader dead or never drained; "
              "falling back to the socket\n",
              p->path.c_str());
    }
  }

  // Reader side: watch a directory for pipes named <prefix>*<suffix>
  // (ours are pslpipe_<ns>_<senderport>_<myport>); the poller attaches
  // them as they appear.  Discovery by scan — no announce handshake —
  // because a booting node sends ADD_NODE before the scheduler ever
  // learns its identity (van.cc:566-577 bootstrap ordering).
  int PipeWatch(const char* dir, const char* prefix, const char* suffix,
                int idle_cap_us) {
    std::lock_guard<std::mutex> lk(pipe_mu_);
    watches_.push_back({dir, prefix, suffix});
    if (idle_cap_us > 0) pipe_idle_cap_us_ = idle_cap_us;
    if (!pipe_thread_.joinable()) {
      pipe_thread_ = std::thread([this] { PipeLoop(); });
    }
    return 0;
  }

  long long PipeSendFrame(WritePipe* p, const iovec* iov, size_t cnt,
                          long long total) {
    // Whole frames are written under the pipe mutex: in-process sender
    // threads must not interleave bytes mid-frame.
    std::lock_guard<std::mutex> lk(p->mu);
    int rc = PipeWriteVec(p, iov, cnt);
    return rc < 0 ? rc : total;
  }

  // Stream the iovecs into the ring.  Frame atomicity rule: the timeout
  // applies only BEFORE the first byte is committed — once any byte is
  // published, aborting would leave a truncated frame and desync the
  // stream forever, so from then on this blocks like a socket sendall,
  // bailing on shutdown or on a DEAD READER: a full ring whose reader
  // has stopped beating (see PipeHdr::reader_beat) will never drain, so
  // blocking "like a socket" would wedge the sender permanently.  A
  // dead-reader bail abandons the pipe entirely (-EPIPE; Send() retires
  // it and falls back to the socket), so the truncated frame is
  // discarded along with the ring, never parsed.
  uint64_t ReaderDeadMs() {
    if (reader_dead_ms_ == 0) {
      const char* e = getenv("PS_SHM_RING_DEAD_MS");
      long v = e ? atol(e) : 0;
      uint64_t ms = v > 0 ? static_cast<uint64_t>(v) : 5000;
      // Floor well above the reader's beat staleness bound (one
      // PipeLoop iteration ≈ the idle cap, sub-ms by default): a
      // threshold at or below the beat cadence would falsely retire
      // live pipes and silently drop their parked frames.
      reader_dead_ms_ = ms < 1000 ? 1000 : ms;
    }
    return reader_dead_ms_;
  }

  int PipeWriteVec(WritePipe* p, const iovec* iov, size_t cnt) {
    if (p->dead.load(std::memory_order_relaxed)) return -EPIPE;
    uint64_t tail = p->hdr->tail.load(std::memory_order_relaxed);
    const uint64_t size = p->hdr->size;
    uint64_t slept_us = 0;
    uint64_t full_since_ms = 0;
    int spins = 0;
    bool committed = false;
    for (size_t i = 0; i < cnt; ++i) {
      const uint8_t* src = static_cast<const uint8_t*>(iov[i].iov_base);
      uint64_t len = iov[i].iov_len;
      while (len) {
        uint64_t head = p->hdr->head.load(std::memory_order_acquire);
        uint64_t space = size - (tail - head);
        if (space == 0) {
          // Reader stalled (or not yet attached): stream semantics mean
          // we must wait, not reroute — rerouting would reorder.
          if (stopped_) return -ECANCELED;
          if (p->dead.load(std::memory_order_relaxed)) return -EPIPE;
          if (++spins < 128) continue;
          timespec ts{0, 50 * 1000};
          nanosleep(&ts, nullptr);
          slept_us += 50;
          if (!committed && slept_us > 60ull * 1000 * 1000) {
            return -ETIMEDOUT;
          }
          // Reader-liveness probe (~every 100ms of full-ring waiting).
          // Inside this wait `head` is by definition frozen (any
          // advance makes space > 0 and exits), so liveness reduces to
          // the reader's heartbeat being recent.  The reader beats
          // every ~1s while attached; 5s of silence on a full ring
          // means dead, desynced-and-blacklisted, or never attached.
          if (slept_us % (100 * 1000) == 0) {
            uint64_t now = NowMs();
            if (full_since_ms == 0) full_since_ms = now;
            uint64_t beat =
                p->hdr->reader_beat.load(std::memory_order_relaxed);
            uint64_t ref = beat > full_since_ms ? beat : full_since_ms;
            // now > ref guard: a beat stamped between our NowMs() and
            // the load can make ref exceed now — unsigned subtraction
            // would underflow and falsely retire a healthy pipe.
            if (now > ref && now - ref > ReaderDeadMs()) {
              p->dead.store(true, std::memory_order_relaxed);
              return -EPIPE;
            }
          }
          continue;
        }
        spins = 0;
        uint64_t pos = tail % size;
        uint64_t n = space < len ? space : len;
        if (n > size - pos) n = size - pos;  // contiguous run
        memcpy(p->data + pos, src, n);
        tail += n;
        src += n;
        len -= n;
        p->hdr->tail.store(tail, std::memory_order_release);
        committed = true;
      }
    }
    return 0;
  }

  // Dial one outbound TCP connection (bounded connect: a black-holed
  // peer must not stall the caller for the kernel's full SYN-retry
  // period).  Returns the fd or -errno.
  int DialTcp(const char* host, int port, int timeout_ms) {
    addrinfo hints{};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    std::string port_s = std::to_string(port);
    if (getaddrinfo(host, port_s.c_str(), &hints, &res) != 0 || !res) {
      return -EHOSTUNREACH;
    }
    int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd < 0) {
      freeaddrinfo(res);
      return -errno;
    }
    int flags = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, flags | O_NONBLOCK);
    int rc = connect(fd, res->ai_addr, res->ai_addrlen);
    freeaddrinfo(res);
    if (rc < 0 && errno == EINPROGRESS) {
      pollfd pfd{fd, POLLOUT, 0};
      rc = poll(&pfd, 1, timeout_ms);
      if (rc <= 0) {
        close(fd);
        return rc == 0 ? -ETIMEDOUT : -errno;
      }
      int err = 0;
      socklen_t len = sizeof(err);
      getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len);
      if (err != 0) {
        close(fd);
        return -err;
      }
    } else if (rc < 0) {
      int err = -errno;
      close(fd);
      return err;
    }
    fcntl(fd, F_SETFL, flags);
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    int snd = sndbuf_.load();
    if (snd > 0) {
      // Same bounded-buffer discipline the Python van applies
      // (PS_TCP_SNDBUF): without it the native and pure-Python planes
      // would run against different kernel buffering.
      setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &snd, sizeof(snd));
    }
    return fd;
  }

  int Connect(int node_id, const char* host, int port, int timeout_ms) {
    int fd = DialTcp(host, port, timeout_ms);
    if (fd < 0) return fd;
    std::lock_guard<std::mutex> lk(send_mu_);
    auto it = send_fds_.find(node_id);
    if (it != send_fds_.end()) close(it->second);
    send_fds_[node_id] = fd;
    return 0;
  }

  // Extra data rail to a peer (PS_NATIVE_RAILS, docs/native_core.md):
  // rail `idx` (1-based beyond the main connection) carries a stripe of
  // each chunked transfer so one lane's goodput is no longer bounded by
  // a single TCP stream's per-byte kernel cost.  Re-dialing an index
  // replaces the old fd (peer recovery redial).
  int AddRail(int node_id, const char* host, int port, int timeout_ms,
              int idx) {
    if (idx < 1 || idx >= kMaxRails) return -EINVAL;
    int fd = DialTcp(host, port, timeout_ms);
    if (fd < 0) return fd;
    std::lock_guard<std::mutex> lk(send_mu_);
    auto& v = rail_fds_[node_id];
    if (v.size() < static_cast<size_t>(idx)) v.resize(idx, -1);
    if (v[idx - 1] >= 0) close(v[idx - 1]);
    v[idx - 1] = fd;
    return 0;
  }

  void SetRails(int n) {
    if (n < 1) n = 1;
    if (n > kMaxRails) n = kMaxRails;
    rails_.store(n);
  }

  void SetSockBuf(int snd, int rcv) {
    sndbuf_.store(snd > 0 ? snd : 0);
    rcvbuf_.store(rcv > 0 ? rcv : 0);
  }

  long long Send(int node_id, const uint8_t* meta, uint32_t meta_len,
                 uint32_t n_data, const uint8_t* const* data,
                 const uint64_t* lens) {
    std::vector<iovec> div(n_data);
    for (uint32_t i = 0; i < n_data; ++i) {
      div[i] = {const_cast<uint8_t*>(data[i]), static_cast<size_t>(lens[i])};
    }
    long long rc = TransmitFrame(node_id, meta, meta_len, div.data(), n_data);
    if (rc >= 0) wx_tx_msgs_.fetch_add(1, std::memory_order_relaxed);
    return rc;
  }

  // Frame one message and write it to the peer's route (pipe or
  // socket).  Shared by the synchronous control-plane Send() and the
  // per-peer sender lanes (TransmitDesc) — both serialize on the same
  // per-fd write locks, so lane frames and inline control frames never
  // interleave mid-frame.
  // The fd rail `rail` of a lane should transmit on, or -1 when the
  // rail has no dedicated connection (fall back to the main path, which
  // also serves pipes).  send_mu_.
  int RailFd(int node_id, int rail) {
    if (rail <= 0) return -1;
    std::lock_guard<std::mutex> lk(send_mu_);
    if (pipes_.count(node_id)) return -1;  // pipe = single ordered stream
    auto it = rail_fds_.find(node_id);
    if (it == rail_fds_.end()) return -1;
    if (static_cast<size_t>(rail) > it->second.size()) return -1;
    return it->second[rail - 1];
  }

  long long TransmitFrame(int node_id, const uint8_t* meta,
                          uint32_t meta_len, const iovec* data_iov,
                          uint32_t n_data, int rail_fd = -1) {
    // Gate against teardown: StopAndJoin must not free pipes while a
    // sender is mid-copy into the mapping.
    struct InflightGuard {
      std::atomic<int>* n;
      explicit InflightGuard(std::atomic<int>* c) : n(c) { ++*n; }
      ~InflightGuard() { --*n; }
    } guard(&inflight_sends_);
    if (stopped_) return -ECANCELED;
    WritePipe* pipe = nullptr;
    int fd = rail_fd;
    if (fd < 0) {
      std::lock_guard<std::mutex> lk(send_mu_);
      auto pit = pipes_.find(node_id);
      if (pit != pipes_.end()) {
        pipe = pit->second;
      } else {
        auto it = send_fds_.find(node_id);
        if (it == send_fds_.end()) return -ENOTCONN;
        fd = it->second;
      }
    }
    uint8_t header[kHeaderSize];
    memcpy(header, &kMagic, 4);
    memcpy(header + 4, &meta_len, 4);
    memcpy(header + 8, &n_data, 4);
    std::vector<uint64_t> lens(n_data);
    std::vector<iovec> iov;
    iov.reserve(3 + n_data);
    iov.push_back({header, kHeaderSize});
    iov.push_back({lens.data(), 8ull * n_data});
    iov.push_back({const_cast<uint8_t*>(meta), meta_len});
    long long total = kHeaderSize + 8ull * n_data + meta_len;
    for (uint32_t i = 0; i < n_data; ++i) {
      lens[i] = data_iov[i].iov_len;
      iov.push_back(data_iov[i]);
      total += static_cast<long long>(lens[i]);
    }
    // A connected pipe carries the WHOLE stream for this peer (mixing
    // pipe and socket frames would lose ordering).
    if (pipe != nullptr) {
      long long rc = PipeSendFrame(pipe, iov.data(), iov.size(), total);
      if (rc != -EPIPE) {
        if (rc >= 0) {
          // Pipe frames are ring memcpys: a frame and its bytes, zero
          // syscalls — exactly the story the observatory should tell.
          wx_tx_frames_.fetch_add(1, std::memory_order_relaxed);
          wx_tx_bytes_.fetch_add(static_cast<uint64_t>(rc),
                                 std::memory_order_relaxed);
        }
        return rc;
      }
      // Reader declared dead (see PipeWriteVec): retire the pipe and
      // fall back to the socket connection, which connect_transport
      // established before the pipe took over routing.  Frames already
      // committed to the abandoned ring are lost (the resender heals
      // them under PS_RESEND) — the reference behaves the same when a
      // transport dies mid-stream.
      RetirePipe(pipe);
      std::lock_guard<std::mutex> lk(send_mu_);
      auto it = send_fds_.find(node_id);
      if (it == send_fds_.end()) return -EPIPE;
      fd = it->second;
    }
    // Serialize writers per peer socket (frames must not interleave).
    std::lock_guard<std::mutex> lk(per_fd_send_mu_[fd % kSendLocks]);
    size_t idx = 0;
    size_t off = 0;
    long long sent_total = 0;
    uint64_t calls = 0;
    while (idx < iov.size()) {
      iovec cur[64];
      int cnt = 0;
      for (size_t i = idx; i < iov.size() && cnt < 64; ++i, ++cnt) {
        cur[cnt] = iov[i];
        if (i == idx && off) {
          cur[cnt].iov_base = static_cast<uint8_t*>(cur[cnt].iov_base) + off;
          cur[cnt].iov_len -= off;
        }
      }
      ssize_t n = writev(fd, cur, cnt);
      ++calls;
      if (n < 0) {
        if (errno == EINTR) continue;
        wx_tx_syscalls_.fetch_add(calls, std::memory_order_relaxed);
        return -errno;
      }
      sent_total += n;
      size_t left = static_cast<size_t>(n);
      // Consume fully-written entries; zero-length iovecs (empty payload
      // segments, e.g. a pull request's vals) must advance even when no
      // bytes remain, or the loop would respin writev forever.
      while (idx < iov.size()) {
        size_t avail = iov[idx].iov_len - off;
        if (avail <= left) {
          left -= avail;
          ++idx;
          off = 0;
        } else {
          off += left;
          break;
        }
      }
    }
    (void)total;
    // One committed batch per frame (local counter, like the Python
    // _sendv): a fully-accepted vector costs exactly one fetch_add.
    wx_tx_syscalls_.fetch_add(calls, std::memory_order_relaxed);
    wx_tx_frames_.fetch_add(1, std::memory_order_relaxed);
    wx_tx_bytes_.fetch_add(static_cast<uint64_t>(sent_total),
                           std::memory_order_relaxed);
    return sent_total;
  }

  // -- per-peer native sender lanes (docs/native_core.md) -----------------

  // Enqueue one data-plane frame (or, with chunk_bytes > 0, one whole
  // chunked transfer) onto the destination's native lane and return a
  // ticket (> 0) immediately; the lane thread transmits GIL-free.  The
  // caller owns keeping the data buffers alive until the ticket is
  // reaped.  chunk_ext_off locates the EXT_CHUNK payload inside the
  // meta template for per-chunk patching.
  long long EnqueueSend(int node_id, int priority, const uint8_t* meta,
                        uint32_t meta_len, uint32_t n_data,
                        const uint8_t* const* data, const uint64_t* lens,
                        uint64_t chunk_bytes, int32_t chunk_ext_off) {
    if (stopped_) return -ECANCELED;
    if (chunk_bytes > 0 &&
        (chunk_ext_off < 0 ||
         static_cast<size_t>(chunk_ext_off) + kChunkFixedSize > meta_len)) {
      return -EINVAL;
    }
    auto* d = new SendDesc();
    d->ticket = ticket_seq_.fetch_add(1) + 1;
    d->node_id = node_id;
    d->priority = priority;
    d->meta.assign(meta, meta + meta_len);
    d->data.resize(n_data);
    for (uint32_t i = 0; i < n_data; ++i) {
      d->data[i] = {const_cast<uint8_t*>(data[i]),
                    static_cast<size_t>(lens[i])};
      d->total_data += lens[i];
    }
    d->chunk_bytes = chunk_bytes;
    d->chunk_ext_off = chunk_ext_off;
    SendLane* lane = LaneFor(node_id);
    long long ticket = static_cast<long long>(d->ticket);
    {
      std::lock_guard<std::mutex> f(flush_mu_);
      pending_descs_.fetch_add(1);
    }
    {
      std::lock_guard<std::mutex> lk(lane->mu);
      if (lane->stop) {
        // Raced a shutdown: complete-as-canceled so the caller's
        // buffer pin is released on its next reap.
        lane->done.emplace_back(d->ticket, -ECANCELED);
        delete d;
        NoteDescDone();
        return ticket;
      }
      lane->q[priority].push_back(d);
    }
    lane->cv.notify_all();
    return ticket;
  }

  // Drain completed (ticket, status) pairs for one peer; status 0 = sent,
  // negative = -errno (including -ECANCELED for shutdown/cancel drops).
  int SendReap(int node_id, uint64_t* tickets, long long* status, int cap) {
    SendLane* lane = nullptr;
    {
      std::lock_guard<std::mutex> lk(lanes_mu_);
      auto it = lanes_.find(node_id);
      if (it == lanes_.end()) return 0;
      lane = it->second;
    }
    std::lock_guard<std::mutex> lk(lane->mu);
    int n = static_cast<int>(lane->done.size());
    if (n > cap) n = cap;
    for (int i = 0; i < n; ++i) {
      tickets[i] = lane->done[i].first;
      status[i] = lane->done[i].second;
    }
    lane->done.erase(lane->done.begin(), lane->done.begin() + n);
    return n;
  }

  // Block until every lane has transmitted (or failed) every queued
  // descriptor — the native analog of the Python _drain_send_lanes.
  int SendFlush(int timeout_ms) {
    std::unique_lock<std::mutex> lk(flush_mu_);
    auto pred = [&] { return pending_descs_.load() == 0 || stopped_; };
    if (timeout_ms < 0) {
      flush_cv_.wait(lk, pred);
      return 0;
    }
    return flush_cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                              pred)
               ? 0
               : -ETIMEDOUT;
  }

  // Drop every QUEUED descriptor for a dead peer (tickets complete as
  // -ECANCELED so Python can fail the owning requests fast).  A
  // descriptor already mid-transmit is not interrupted — its writev
  // fails on the broken socket.
  long long SendCancel(int node_id) {
    SendLane* lane = nullptr;
    {
      std::lock_guard<std::mutex> lk(lanes_mu_);
      auto it = lanes_.find(node_id);
      if (it == lanes_.end()) return 0;
      lane = it->second;
    }
    long long n = 0;
    {
      std::lock_guard<std::mutex> lk(lane->mu);
      for (auto& kv : lane->q) {
        for (SendDesc* d : kv.second) {
          if (d->inflight > 0) {
            // A preempted transfer with a rail still mid-writev on one
            // of its chunks: poison it — the last writer reports the
            // ticket as canceled (deleting here would be a UAF).
            d->canceled = true;
          } else {
            lane->done.emplace_back(d->ticket, -ECANCELED);
            delete d;
            ++n;
          }
        }
      }
      lane->q.clear();
    }
    lane->cv.notify_all();
    for (long long i = 0; i < n; ++i) NoteDescDone();
    return n;
  }

  // Peer recovery: a restarted peer expects the sid sequence to begin
  // at 0 again (the Python _reset_peer_sids counterpart).
  void SendResetSid(int node_id) {
    std::lock_guard<std::mutex> lk(lanes_mu_);
    auto it = lanes_.find(node_id);
    if (it != lanes_.end()) it->second->sid.store(0);
  }

  void SetReassembly(int on) { reassemble_.store(on != 0); }

  // Returns 1 with a frame, 0 on timeout, -1 when stopped.  Express
  // frames (priority > 0 data — see FrameIsExpress) pop first so a
  // priority op never waits behind a bulk chunk backlog; each lane is
  // FIFO, matching the Python PriorityRecvQueue discipline.
  int Recv(Frame* out, int timeout_ms) {
    std::unique_lock<std::mutex> lk(queue_mu_);
    auto ready = [this] {
      return stopped_ || !express_.empty() || !queue_.empty();
    };
    if (timeout_ms < 0) {
      queue_cv_.wait(lk, ready);
    } else if (!queue_cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   ready)) {
      return 0;
    }
    std::deque<Frame>* q =
        !express_.empty() ? &express_ : (!queue_.empty() ? &queue_ : nullptr);
    if (q != nullptr) {
      *out = q->front();
      q->pop_front();
      return 1;
    }
    return stopped_ ? -1 : 0;
  }

  // One-call wire-plane snapshot: every counter read relaxed into the
  // caller's struct.  Totals are monotonic; the Python side diffs
  // against its previous snapshot, so relaxed reads racing live
  // increments only ever defer a count to the next snapshot.
  void StatsSnapshot(psl_wire_stats* out) const {
    out->abi = kAbiVersion;
    out->tx_syscalls = wx_tx_syscalls_.load(std::memory_order_relaxed);
    out->tx_frames = wx_tx_frames_.load(std::memory_order_relaxed);
    out->tx_chunks = wx_tx_chunks_.load(std::memory_order_relaxed);
    out->tx_bytes = wx_tx_bytes_.load(std::memory_order_relaxed);
    out->tx_msgs = wx_tx_msgs_.load(std::memory_order_relaxed);
    out->rx_syscalls = wx_rx_syscalls_.load(std::memory_order_relaxed);
    out->rx_frames = wx_rx_frames_.load(std::memory_order_relaxed);
    out->rx_bytes_copy = wx_rx_bytes_copy_.load(std::memory_order_relaxed);
    out->rx_bytes_zc = wx_rx_bytes_zc_.load(std::memory_order_relaxed);
    out->rx_pool_hits = wx_rx_pool_hits_.load(std::memory_order_relaxed);
    out->rx_pool_misses =
        wx_rx_pool_misses_.load(std::memory_order_relaxed);
  }

  void Stop() {
    stopped_ = true;
    if (listen_fd_ >= 0) {
      shutdown(listen_fd_, SHUT_RDWR);
      close(listen_fd_);
      listen_fd_ = -1;
    }
    if (!bound_path_.empty()) {
      unlink(bound_path_.c_str());
      bound_path_.clear();
    }
    // Wake every sender lane (they drain-as-canceled and retire) and
    // unwedge any writev blocked on a black-holed peer: the Python van
    // flushes the lanes BEFORE stop, so anything still in flight here
    // is already abandoned.
    {
      std::lock_guard<std::mutex> lk(send_mu_);
      for (auto& kv : send_fds_) shutdown(kv.second, SHUT_RDWR);
      for (auto& kv : rail_fds_) {
        for (int fd : kv.second) {
          if (fd >= 0) shutdown(fd, SHUT_RDWR);
        }
      }
    }
    {
      std::lock_guard<std::mutex> lk(lanes_mu_);
      for (auto& kv : lanes_) kv.second->cv.notify_all();
    }
    flush_cv_.notify_all();
    queue_cv_.notify_all();
  }

  void StopAndJoin() {
    Stop();
    // Sender lanes first: their threads write through pipes/sockets the
    // teardown below frees.
    std::vector<SendLane*> lanes;
    {
      std::lock_guard<std::mutex> lk(lanes_mu_);
      for (auto& kv : lanes_) lanes.push_back(kv.second);
      lanes_.clear();
    }
    for (SendLane* lane : lanes) {
      {
        std::lock_guard<std::mutex> lk(lane->mu);
        lane->stop = true;
      }
      lane->cv.notify_all();
    }
    for (SendLane* lane : lanes) {
      for (std::thread& t : lane->threads) {
        if (t.joinable()) t.join();
      }
      delete lane;
    }
    if (io_thread_.joinable()) io_thread_.join();
    for (std::thread& t : io_threads_) {
      if (t.joinable()) t.join();
    }
    io_threads_.clear();
    if (pipe_thread_.joinable()) pipe_thread_.join();
    // Wait for in-flight Sends to drain: freeing a pipe mapping under a
    // sender's memcpy would be a use-after-munmap (stopped_ makes them
    // bail at their next ring-full or entry check).
    for (int i = 0; i < 5000 && inflight_sends_.load() > 0; ++i) {
      timespec ts{0, 1000 * 1000};
      nanosleep(&ts, nullptr);
    }
    for (auto& kv : rpipes_) ClosePipe(kv.second);
    rpipes_.clear();
    std::lock_guard<std::mutex> lk(send_mu_);
    for (auto& kv : pipes_by_path_) {
      WritePipe* p = kv.second;
      munmap(reinterpret_cast<void*>(p->hdr), p->map_len);
      close(p->fd);  // releases the writer-liveness LOCK_SH
      unlink(p->path.c_str());
      // The sibling .lock file stays behind (as the unix-socket path's
      // do): unlinking it would hand a concurrent locker a different
      // inode, reopening the reclaim/create race the flock exists to
      // close.  They are empty files; ReclaimIfDead removes them under
      // LOCK_EX when it reclaims a name.
      delete p;
    }
    pipes_by_path_.clear();
    pipes_.clear();
    for (WritePipe* p : dead_write_pipes_) {
      // Retired at runtime (dead reader): fd closed and name unlinked
      // then; only the parked mapping remains.
      munmap(reinterpret_cast<void*>(p->hdr), p->map_len);
      delete p;
    }
    dead_write_pipes_.clear();
    for (auto& kv : send_fds_) close(kv.second);
    send_fds_.clear();
    for (auto& kv : rail_fds_) {
      for (int fd : kv.second) {
        if (fd >= 0) close(fd);
      }
    }
    rail_fds_.clear();
    {
      std::lock_guard<std::mutex> clk(conns_mu_);
      for (auto& kv : conns_) {
        close(kv.second->fd);
        AbandonScatter(kv.second);
        delete kv.second;
      }
      conns_.clear();
    }
    {
      std::lock_guard<std::mutex> xlk(xfers_mu_);
      for (auto& kv : xfers_) FramePool::Release(kv.second.buf);
      xfers_.clear();
    }
    if (epfd_ >= 0) {
      close(epfd_);
      epfd_ = -1;
    }
    for (int ep : extra_epfds_) close(ep);
    extra_epfds_.clear();
    std::lock_guard<std::mutex> qlk(queue_mu_);
    for (auto& f : queue_) FramePool::Release(f.buf);
    queue_.clear();
    for (auto& f : express_) FramePool::Release(f.buf);
    express_.clear();
  }

 private:
  static constexpr int kSendLocks = 64;
  static constexpr int kMaxRails = 8;

  SendLane* LaneFor(int node_id) {
    std::lock_guard<std::mutex> lk(lanes_mu_);
    auto it = lanes_.find(node_id);
    if (it != lanes_.end()) return it->second;
    auto* lane = new SendLane();
    int n = rails_.load();
    for (int r = 0; r < n; ++r) {
      lane->threads.emplace_back([this, node_id, lane, r] {
        RailLoop(node_id, lane, r);
      });
    }
    lanes_[node_id] = lane;
    return lane;
  }

  void NoteDescDone() {
    {
      std::lock_guard<std::mutex> f(flush_mu_);
      pending_descs_.fetch_sub(1);
    }
    flush_cv_.notify_all();
  }

  void StampSid(uint8_t* meta, uint32_t meta_len, SendLane* lane) {
    if (meta_len < kMetaFixedSize) return;
    int32_t sid = lane->sid.fetch_add(1);
    memcpy(meta + kMetaSidOff, &sid, sizeof(sid));
  }

  // Whether rail `rail` can make progress right now.  lane->mu held.
  //
  // A monolithic frame — and the FINAL chunk of every transfer — is
  // reserved for rail 0: every descriptor's completion marker then
  // rides one FIFO stream, so the receiver observes transfer
  // completions (and with them the server's apply slots) in exactly
  // the claim order, no matter how the rails' socket buffers drain.
  bool RailHasClaim(SendLane* lane, int rail) {
    SendDesc* d = lane->active;
    if (d == nullptr) return !lane->q.empty();
    if (!lane->q.empty() && lane->q.begin()->first > d->priority) {
      return true;  // preemption is work for any rail
    }
    uint64_t remaining = d->total_data - d->sent_offset;
    if (d->chunk_bytes == 0) return rail == 0;
    if (remaining == 0) return false;  // fully claimed; writers draining
    if (remaining <= d->chunk_bytes && rail != 0) return false;
    return true;
  }

  // Claim-and-transmit loop of one rail thread (PS_NATIVE_RAILS rail
  // threads per peer).  Rails cooperatively drain the ONE active
  // descriptor: each claims the next chunk under the lane lock (sid
  // stamped at claim, so sid order == claim order), patches a
  // rail-local copy of the meta template, and writev's on its own
  // connection — one transfer's chunks stream in parallel over N TCP
  // streams while descriptor order stays strict FIFO-within-level.
  // Frames are byte-identical to the single-rail plane's.
  void RailLoop(int node_id, SendLane* lane, int rail) {
    char name[16];
    snprintf(name, sizeof(name), "psl-lane-%d.%d", node_id, rail);
    pthread_setname_np(pthread_self(), name);
    std::vector<uint8_t> tmeta;   // rail-local template copy
    std::vector<iovec> slices;
    std::unique_lock<std::mutex> lk(lane->mu);
    while (true) {
      lane->cv.wait(lk, [&] {
        return stopped_ || lane->stop || RailHasClaim(lane, rail);
      });
      if (stopped_ || lane->stop) break;
      // Promote the next descriptor / preempt a mid-transfer bulk.
      if (lane->active == nullptr) {
        auto it = lane->q.begin();  // highest priority, FIFO within
        lane->active = it->second.front();
        it->second.pop_front();
        if (it->second.empty()) lane->q.erase(it);
        // The promoted frame may be claimable only by ANOTHER rail
        // (monolithic / final chunk → rail 0).
        lane->cv.notify_all();
      } else if (!lane->q.empty() &&
                 lane->q.begin()->first > lane->active->priority) {
        // Partially-claimed transfer back to the FRONT of its level —
        // later same-priority sends still wait for the whole transfer
        // (Python lane order), only higher priority jumps.
        lane->q[lane->active->priority].push_front(lane->active);
        auto it = lane->q.begin();
        lane->active = it->second.front();
        it->second.pop_front();
        if (it->second.empty()) lane->q.erase(it);
        lane->cv.notify_all();
      }
      if (!RailHasClaim(lane, rail)) continue;
      SendDesc* d = lane->active;
      // Claim the next chunk (a monolithic frame claims whole).
      bool mono = d->chunk_bytes == 0;
      uint64_t lo = d->sent_offset;
      uint64_t hi = mono ? d->total_data : lo + d->chunk_bytes;
      if (hi > d->total_data) hi = d->total_data;
      uint32_t index = d->next_index;
      d->sent_offset = hi;
      d->next_index++;
      if (d->sent_offset >= d->total_data) {
        // Fully claimed: the next descriptor may start while this
        // one's last writev is still in flight (its completion marker
        // is already ordered ahead on rail 0).
        lane->active = nullptr;
        lane->cv.notify_all();
      }
      d->inflight++;
      long long rc = 0;
      if (d->error == 0 && !d->canceled) {
        tmeta.assign(d->meta.begin(), d->meta.end());
        uint32_t meta_len = static_cast<uint32_t>(tmeta.size());
        StampSid(tmeta.data(), meta_len, lane);
        if (mono) {
          lk.unlock();
          rc = TransmitFrame(node_id, tmeta.data(), meta_len,
                             d->data.data(),
                             static_cast<uint32_t>(d->data.size()));
          lk.lock();
        } else {
          uint8_t* ext = tmeta.data() + d->chunk_ext_off;
          memcpy(ext + kChunkIndexOff, &index, 4);
          memcpy(ext + kChunkOffsetOff, &lo, 8);
          // The byte range's slices of the original segments, in
          // order — exactly split_message's per-chunk data list
          // (wire.py lens table entries come out identical).
          slices.clear();
          uint64_t pos = 0;
          for (const iovec& seg : d->data) {
            uint64_t a = lo > pos ? lo : pos;
            uint64_t b = pos + seg.iov_len < hi ? pos + seg.iov_len : hi;
            if (a < b) {
              slices.push_back(
                  {static_cast<uint8_t*>(seg.iov_base) + (a - pos),
                   static_cast<size_t>(b - a)});
            }
            pos += seg.iov_len;
            if (pos >= hi) break;
          }
          lk.unlock();
          rc = TransmitFrame(node_id, tmeta.data(), meta_len,
                             slices.data(),
                             static_cast<uint32_t>(slices.size()),
                             RailFd(node_id, rail));
          if (rc >= 0) {
            wx_tx_chunks_.fetch_add(1, std::memory_order_relaxed);
          }
          lk.lock();
        }
      }
      d->inflight--;
      if (rc < 0 && d->error == 0) d->error = rc;
      bool poisoned = d->canceled || d->error != 0;
      if (d->inflight == 0 &&
          (poisoned || d->sent_offset >= d->total_data)) {
        if (lane->active == d) {
          lane->active = nullptr;
          lane->cv.notify_all();
        } else if (poisoned) {
          // A poisoned descriptor that was PREEMPTED mid-transfer
          // still sits at the front of its level's queue (the
          // preemption push_front) — unlink it before the delete, or
          // a later promotion pops freed memory (SendCancel clears
          // the queue itself; a writev error on a broken socket
          // reaches here with the descriptor still enqueued).
          auto qit = lane->q.find(d->priority);
          if (qit != lane->q.end()) {
            auto pos = std::find(qit->second.begin(), qit->second.end(),
                                 d);
            if (pos != qit->second.end()) qit->second.erase(pos);
            if (qit->second.empty()) lane->q.erase(qit);
          }
        }
        if (!d->canceled && d->error == 0) {
          wx_tx_msgs_.fetch_add(1, std::memory_order_relaxed);
        }
        lane->done.emplace_back(
            d->ticket, d->canceled ? -ECANCELED
                                   : (d->error < 0 ? d->error : 0));
        delete d;
        lk.unlock();
        NoteDescDone();
        lk.lock();
      }
    }
    // Stop-drain: cancel the backlog so every ticket still completes
    // (Python's reap releases the pinned buffers either way).  First
    // rail to exit does it; descriptors with writers still in flight
    // are only POISONED — their last writer reports the ticket.
    if (!lane->drained) {
      lane->drained = true;
      long long dropped = 0;
      for (auto& kv : lane->q) {
        for (SendDesc* d : kv.second) {
          if (d->inflight > 0) {
            d->canceled = true;
          } else {
            lane->done.emplace_back(d->ticket, -ECANCELED);
            delete d;
            ++dropped;
          }
        }
      }
      lane->q.clear();
      SendDesc* a = lane->active;
      if (a != nullptr && a->inflight == 0 &&
          a->sent_offset < a->total_data) {
        lane->active = nullptr;
        lane->done.emplace_back(a->ticket, -ECANCELED);
        delete a;
        ++dropped;
      } else if (a != nullptr && a->inflight > 0) {
        a->canceled = true;
      }
      lk.unlock();
      for (long long i = 0; i < dropped; ++i) NoteDescDone();
    }
  }

  void PipeLoop() {
    pthread_setname_np(pthread_self(), "psl-pipe");
    uint64_t idle_us = 0;
    uint64_t last_scan_ms = 0, last_live_ms = 0;
    while (!stopped_) {
      uint64_t now_ms = NowMs();
      if (now_ms - last_scan_ms >= 100) {
        last_scan_ms = now_ms;
        ScanPipes();
      }
      bool check_liveness = false;
      if (now_ms - last_live_ms >= 1000) {
        last_live_ms = now_ms;
        check_liveness = true;
      }
      long long moved = 0;
      for (auto it = rpipes_.begin(); it != rpipes_.end();) {
        ReadPipe* rp = it->second;
        // Reader heartbeat: tells a blocked writer this ring IS being
        // drained (see PipeHdr::reader_beat).  Stamped every loop
        // iteration — liveness, not progress — so its staleness is
        // bounded by one iteration (≈ the idle-backoff cap), far under
        // the 1000 ms floor of the writer's dead threshold.
        rp->hdr->reader_beat.store(NowMs(), std::memory_order_relaxed);
        long long n = PumpPipe(rp);
        if (n > 0) moved += n;
        bool drop = n < 0;
        if (drop) {
          struct stat st{};
          if (fstat(rp->fd, &st) == 0) {
            bad_pipes_[rp->path] = st.st_ino;
          }
        }
        if (!drop && check_liveness && n == 0) {
          drop = ReclaimIfDead(rp);
        }
        if (drop) {
          ClosePipe(rp);
          it = rpipes_.erase(it);
        } else {
          ++it;
        }
      }
      if (moved) {
        idle_us = 0;
      } else {
        // Exponential backoff, capped: the cap trades idle CPU for tail
        // latency (PS_SHM_RING_IDLE_US; single-core hosts want it high,
        // dedicated cores can spin near zero).
        uint64_t cap = pipe_idle_cap_us_;
        idle_us = idle_us ? (idle_us * 2 < cap ? idle_us * 2 : cap) : 2;
        timespec ts{0, static_cast<long>(idle_us * 1000)};
        nanosleep(&ts, nullptr);
      }
    }
  }

  static uint64_t NowMs() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<uint64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
  }

  // Detach (and possibly reclaim the name of) a pipe whose writer died.
  // Serialized under the sibling .lock and guarded by an inode check: a
  // restarted writer may have already recreated the NAME with a fresh
  // inode — unlinking blindly would orphan the new generation's pipe.
  bool ReclaimIfDead(ReadPipe* rp) {
    if (flock(rp->fd, LOCK_EX | LOCK_NB) != 0) return false;  // writer alive
    flock(rp->fd, LOCK_UN);
    std::string lockp = rp->path + ".lock";
    int lock_fd = open(lockp.c_str(), O_CREAT | O_RDWR, 0600);
    if (lock_fd < 0) return true;  // detach; scan re-attaches if live
    if (flock(lock_fd, LOCK_EX | LOCK_NB) != 0) {
      close(lock_fd);  // a writer is mid-create on this name: just detach
      return true;
    }
    struct stat st_name{}, st_mine{};
    if (stat(rp->path.c_str(), &st_name) != 0) {
      // Writer already unlinked the pipe; drop the .lock we just
      // recreated with O_CREAT or it leaks in /dev/shm forever.
      unlink(lockp.c_str());
    } else if (fstat(rp->fd, &st_mine) == 0 &&
               st_name.st_ino == st_mine.st_ino &&
               flock(rp->fd, LOCK_EX | LOCK_NB) == 0) {
      unlink(rp->path.c_str());
      unlink(lockp.c_str());
    }
    flock(lock_fd, LOCK_UN);
    close(lock_fd);
    return true;
  }

  void ScanPipes() {
    std::vector<std::array<std::string, 3>> watches;
    {
      std::lock_guard<std::mutex> lk(pipe_mu_);
      watches = watches_;
    }
    for (const auto& w : watches) {
      DIR* d = opendir(w[0].c_str());
      if (!d) continue;
      while (dirent* e = readdir(d)) {
        std::string name = e->d_name;
        if (name.size() < w[1].size() + w[2].size()) continue;
        if (name.compare(0, w[1].size(), w[1]) != 0) continue;
        if (name.compare(name.size() - w[2].size(), w[2].size(), w[2]) != 0)
          continue;
        std::string path = w[0] + "/" + name;
        if (rpipes_.count(path)) continue;
        // A pipe dropped for a protocol error stays blacklisted for its
        // inode's lifetime — re-attaching the same desynced stream would
        // loop attach/fail forever.  A fresh inode (writer restarted)
        // clears the entry.
        auto bad = bad_pipes_.find(path);
        if (bad != bad_pipes_.end()) {
          struct stat st{};
          if (stat(path.c_str(), &st) == 0 &&
              static_cast<uint64_t>(st.st_ino) == bad->second) {
            continue;
          }
          bad_pipes_.erase(bad);
        }
        TryAttachPipe(path);
      }
      closedir(d);
    }
  }

  void TryAttachPipe(const std::string& path) {
    std::string lockp = path + ".lock";
    int lock_fd = open(lockp.c_str(), O_CREAT | O_RDWR, 0600);
    if (lock_fd < 0) return;
    flock(lock_fd, LOCK_EX);
    int fd = open(path.c_str(), O_RDWR);
    if (fd < 0) {
      // Pipe vanished between scan and attach: drop the .lock we may
      // have just created.
      unlink(lockp.c_str());
    }
    if (fd >= 0) {
      if (flock(fd, LOCK_EX | LOCK_NB) == 0) {
        // No live writer: stale leftover — reclaim the name.
        unlink(path.c_str());
        unlink(lockp.c_str());
        close(fd);
      } else {
        struct stat st{};
        if (fstat(fd, &st) == 0 &&
            static_cast<size_t>(st.st_size) > kPipeDataOff) {
          size_t map_len = st.st_size;
          void* mem = mmap(nullptr, map_len, PROT_READ | PROT_WRITE,
                           MAP_SHARED, fd, 0);
          if (mem != MAP_FAILED) {
            auto* hdr = static_cast<PipeHdr*>(mem);
            if (hdr->magic == kPipeMagic &&
                hdr->size == map_len - kPipeDataOff) {
              auto* rp = new ReadPipe();
              rp->hdr = hdr;
              rp->data = static_cast<uint8_t*>(mem) + kPipeDataOff;
              rp->fd = fd;
              rp->map_len = map_len;
              rp->path = path;
              hdr->reader_beat.store(NowMs(), std::memory_order_relaxed);
              rpipes_[path] = rp;
              fd = -1;  // owned by rp now
            } else {
              munmap(mem, map_len);
            }
          }
        }
        if (fd >= 0) close(fd);
      }
    }
    flock(lock_fd, LOCK_UN);
    close(lock_fd);
  }

  // Drain available pipe bytes through the frame state machine.
  // Returns bytes consumed, or -1 on protocol error.
  long long PumpPipe(ReadPipe* rp) {
    Conn* c = &rp->conn;
    uint64_t head = rp->hdr->head.load(std::memory_order_relaxed);
    const uint64_t size = rp->hdr->size;
    long long consumed = 0;
    while (true) {
      uint64_t tail = rp->hdr->tail.load(std::memory_order_acquire);
      uint64_t avail = tail - head;
      if (avail == 0) break;
      uint64_t n = c->want - c->got;
      if (n > avail) n = avail;
      uint64_t pos = head % size;
      if (n > size - pos) n = size - pos;
      memcpy(StageDst(c), rp->data + pos, n);
      wx_rx_bytes_copy_.fetch_add(n, std::memory_order_relaxed);
      c->got += n;
      head += n;
      consumed += static_cast<long long>(n);
      rp->hdr->head.store(head, std::memory_order_release);
      // Same want == got transition loop as ReadConn: a meta-only
      // frame's lens and payload stages are zero-length.
      while (c->got == c->want) {
        if (!OnStageComplete(c)) return -1;
      }
    }
    return consumed;
  }

  void ClosePipe(ReadPipe* rp) {
    AbandonScatter(&rp->conn);
    munmap(const_cast<uint8_t*>(
               reinterpret_cast<const uint8_t*>(rp->hdr)),
           rp->map_len);
    close(rp->fd);
    delete rp;
  }

  // Register the listener (sentinel data.ptr == nullptr) on the primary
  // epoll and start the primary receive thread.  Further receive pumps
  // spawn lazily, one per ACCEPTED connection (capped, PSL_IO_THREADS):
  // round-robin sharding at accept used to put both of a 2-rail peer's
  // data streams on the same pump whenever an idle control conn
  // happened to occupy the other slot — a 50/50 accept-order lottery
  // that degraded multi-rail receive to single-stream goodput
  // (measured: the tcp bench's sticky ~13 vs ~18.5 Gbps modes).
  void StartIo() {
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = nullptr;
    epoll_ctl(epfd_, EPOLL_CTL_ADD, listen_fd_, &ev);
    const char* cap = getenv("PSL_IO_THREADS");
    max_io_threads_ = cap != nullptr ? atoi(cap) : 8;
    if (max_io_threads_ < 1) max_io_threads_ = 1;
    io_thread_ = std::thread([this] { IoLoop(epfd_); });
  }

  void IoLoop(int epfd) {
    pthread_setname_np(pthread_self(), "psl-io");
    epoll_event events[64];
    while (!stopped_) {
      int n = epoll_wait(epfd, events, 64, 100);
      if (n < 0) {
        if (errno == EINTR) continue;
        break;
      }
      for (int i = 0; i < n; ++i) {
        if (events[i].data.ptr == nullptr) {
          AcceptAll();  // listener lives on the primary epoll only
          continue;
        }
        auto* c = static_cast<Conn*>(events[i].data.ptr);
        if (!ReadConn(c)) {
          epoll_ctl(epfd, EPOLL_CTL_DEL, c->fd, nullptr);
          close(c->fd);
          {
            std::lock_guard<std::mutex> lk(conns_mu_);
            conns_.erase(c->fd);
          }
          AbandonScatter(c);
          delete c;
        }
      }
    }
  }

  void AcceptAll() {
    while (true) {
      int fd = accept4(listen_fd_, nullptr, nullptr, SOCK_NONBLOCK);
      if (fd < 0) break;
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      int rcv = rcvbuf_.load();
      if (rcv > 0) {
        setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcv, sizeof(rcv));
      }
      auto* conn = new Conn();
      conn->fd = fd;
      {
        std::lock_guard<std::mutex> lk(conns_mu_);
        conns_[fd] = conn;
      }
      // Each accepted conn gets its own epoll + pump thread while
      // under the cap (every stream drains independently — no
      // accept-order lottery pairing two hot rails on one pump);
      // beyond the cap, round-robin over the existing pumps.  Each
      // Conn is read by exactly one thread, so its frame state
      // machine stays single-threaded.  Only this (primary) thread
      // mutates extra_epfds_/io_threads_, and Stop() joins it first.
      int ep = epfd_;
      if (static_cast<int>(extra_epfds_.size()) < max_io_threads_ - 1) {
        int nep = epoll_create1(0);
        if (nep >= 0) {
          extra_epfds_.push_back(nep);
          io_threads_.emplace_back([this, nep] { IoLoop(nep); });
          ep = nep;
        }
      } else if (!extra_epfds_.empty()) {
        size_t slot = accept_rr_++ % (extra_epfds_.size() + 1);
        if (slot > 0) ep = extra_epfds_[slot - 1];
      }
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.ptr = conn;
      epoll_ctl(ep, EPOLL_CTL_ADD, fd, &ev);
    }
  }

  // Byte sink of the frame state machine for the current stage.
  static uint8_t* StageDst(Conn* c) {
    if (c->stage == 0) return c->header + c->got;
    if (c->stage == 3) {
      // Payload: straight into the transfer buffer (direct-read
      // scatter) or appended after lens+meta in the frame block.
      if (c->scatter_dst != nullptr) return c->scatter_dst + c->got;
      return c->frame.buf + 8ull * c->frame.n_data + c->frame.meta_len +
             c->got;
    }
    return c->frame.buf + c->got;
  }

  static void ResetStage(Conn* c) {
    c->scatter_dst = nullptr;
    c->drop_frame = false;
    c->dup_chunk = false;
    c->stage = 0;
    c->want = kHeaderSize;
    c->got = 0;
  }

  // Stage transition once got == want.  Returns false on protocol
  // error.  Shared by the fd reader and the shm-pipe pump: both are
  // byte streams feeding the same reassembly.  A stage may complete
  // with want == got (empty lens table, empty payload), so callers
  // must re-invoke until want > got (see ReadConn/PumpPipe).
  bool OnStageComplete(Conn* c) {
    if (c->stage == 0) {
      uint32_t magic, meta_len, n_data;
      memcpy(&magic, c->header, 4);
      memcpy(&meta_len, c->header + 4, 4);
      memcpy(&n_data, c->header + 8, 4);
      if (magic != kMagic) return false;
      c->frame.meta_len = meta_len;
      c->frame.n_data = n_data;
      // Lens + meta land in one right-sized block; the payload's
      // destination is decided only after the meta is readable.
      c->body_size = 8ull * n_data + meta_len;
      bool pool_hit = false;
      c->frame.buf = FramePool::Alloc(c->body_size, &pool_hit);
      (pool_hit ? wx_rx_pool_hits_ : wx_rx_pool_misses_)
          .fetch_add(1, std::memory_order_relaxed);
      c->stage = 1;
      c->want = 8ull * n_data;  // lens arrive first
      c->got = 0;
    } else if (c->stage == 1) {
      // Lens complete: meta follows in the same block (got continues).
      c->stage = 2;
      c->want = c->body_size;
    } else if (c->stage == 2) {
      return OnMetaComplete(c);
    } else {
      OnPayloadComplete(c);
    }
    return true;
  }

  // Meta complete: learn the payload size and route the payload bytes.
  // A reassembly-eligible chunk frame's payload reads DIRECTLY into
  // its transfer's buffer at the chunk's byte offset — the only pass
  // over the data; everything else grows the frame block to the full
  // body and delivers as-is.
  bool OnMetaComplete(Conn* c) {
    uint64_t payload = 0;
    const uint64_t* lens = reinterpret_cast<uint64_t*>(c->frame.buf);
    for (uint32_t i = 0; i < c->frame.n_data; ++i) payload += lens[i];
    if (reassemble_ && payload > 0 && BeginChunkScatter(c, payload)) {
      c->stage = 3;
      c->want = payload;
      c->got = 0;
      return true;
    }
    if (payload == 0) {
      // Meta-only frame (control, empty vals): deliver as-is.
      EnqueueFrame(c->frame);
      c->frame = Frame();
      ResetStage(c);
      return true;
    }
    // Pool-aware "realloc": move lens+meta into a full-body block.
    size_t full = c->body_size + payload;
    uint8_t* grown = FramePool::Alloc(full);
    if (grown != nullptr && c->frame.buf != nullptr) {
      memcpy(grown, c->frame.buf, c->body_size);
    }
    FramePool::Release(c->frame.buf);
    c->frame.buf = grown;
    c->stage = 3;
    c->want = payload;
    c->got = 0;
    return true;
  }

  // Payload complete: finish the direct-read absorb (complete
  // transfers deliver as ONE frame), discard a dropped frame, or
  // deliver the ordinary full frame.  Marking received + enqueueing
  // the completed transfer is ONE xfers_mu_ critical section: with
  // chunks striped over rails, transfer N+1's last chunk lands
  // strictly after transfer N's (per-rail FIFO + final-chunk-on-rail-0
  // sender discipline), so serialized mark+enqueue keeps completion
  // delivery in submission order.
  void OnPayloadComplete(Conn* c) {
    if (c->scatter_dst != nullptr) {
      std::lock_guard<std::mutex> lk(xfers_mu_);
      auto it = xfers_.find(c->pending_key);
      if (it != xfers_.end()) {
        ConnXfer& x = it->second;
        x.readers--;
        if (!c->dup_chunk && !x.dropped) {
          x.received[c->pending_index] = true;
          x.got++;
        }
        if (x.dropped) {
          if (x.readers == 0) {
            FramePool::Release(x.buf);
            xfers_.erase(it);
          }
        } else if (x.got == x.total && x.readers == 0) {
          Frame out;
          out.buf = x.buf;
          out.meta_len = x.meta_len;
          out.n_data = x.nseg;
          xfers_.erase(it);
          EnqueueFrame(out);
        }
      }
      FramePool::Release(c->frame.buf);
      c->frame = Frame();
    } else if (c->drop_frame) {
      FramePool::Release(c->frame.buf);
      c->frame = Frame();
    } else {
      EnqueueFrame(c->frame);
      c->frame = Frame();
    }
    ResetStage(c);
  }

  // A conn died mid-payload while direct-reading into a transfer
  // buffer: release its reader ref so the entry can be evicted (the
  // index was never marked received — the partial bytes are simply
  // dead weight until then).
  void AbandonScatter(Conn* c) {
    if (c->stage != 3 || c->scatter_dst == nullptr) return;
    std::lock_guard<std::mutex> lk(xfers_mu_);
    auto it = xfers_.find(c->pending_key);
    if (it == xfers_.end()) return;
    ConnXfer& x = it->second;
    x.readers--;
    if (x.dropped && x.readers == 0) {
      FramePool::Release(x.buf);
      xfers_.erase(it);
    }
    c->scatter_dst = nullptr;
  }

  void EnqueueFrame(const Frame& f) {
    wx_rx_frames_.fetch_add(1, std::memory_order_relaxed);
    {
      std::lock_guard<std::mutex> lk(queue_mu_);
      if (recv_priority_ && FrameIsExpress(f)) {
        express_.push_back(f);
      } else {
        queue_.push_back(f);
      }
    }
    queue_cv_.notify_one();
  }

  // The EXT_CHUNK payload inside a packed meta, or nullptr when the
  // frame is not a (reassembly-eligible) chunk.  Data frames carry no
  // node list, so the extension tail sits at a computable offset.
  static const uint8_t* FindChunkExt(const uint8_t* meta,
                                     uint32_t meta_len) {
    if (meta_len < kMetaFixedSize) return nullptr;
    if (meta[kMetaControlCmdOff] != 0) return nullptr;
    uint16_t num_nodes;
    memcpy(&num_nodes, meta + kMetaNumNodesOff, 2);
    if (num_nodes != 0) return nullptr;
    uint16_t ndt;
    memcpy(&ndt, meta + kMetaNumDtypesOff, 2);
    uint32_t body_len;
    memcpy(&body_len, meta + kMetaBodyLenOff, 4);
    size_t off = kMetaFixedSize + ndt + body_len;
    while (off + 2 <= meta_len) {
      uint8_t tag = meta[off];
      uint8_t len = meta[off + 1];
      off += 2;
      if (off + len > meta_len) return nullptr;
      if (tag == kExtChunkTag) {
        if (len < kChunkFixedSize) return nullptr;
        uint8_t nseg = meta[off + kChunkNsegOff];
        if (len != kChunkFixedSize + nseg * kChunkSegEntry) return nullptr;
        return meta + off;
      }
      off += len;  // unknown tags skip by length
    }
    return nullptr;
  }

  // Matches the Python ChunkAssembler's table cap.  Eviction of a
  // LIVE transfer (a high-fan-in receiver with 256+ concurrent
  // chunked pushes) loses it permanently — later chunks re-create a
  // phantom entry that can never complete and the sender only
  // recovers via its request deadline — so evictions warn loudly.
  static constexpr size_t kMaxXfers = 256;

  // Native receive-side DIRECT-READ scatter: called at meta-complete
  // time (the payload is still in the kernel), so an eligible chunk
  // frame's payload bytes can be read straight into the transfer's
  // reassembly buffer at the chunk's byte offset — the chunk's payload
  // is a contiguous byte range of the original segments'
  // concatenation, which is exactly the frame body layout.  Returns
  // true when stage 3 was routed (scatter_dst set, or drop_frame for
  // an inconsistent chunk whose payload must be consumed and
  // discarded); false leaves the ordinary deliver-raw path (not a
  // chunk, or allocation failure — Python's assembler remains the
  // fallback).
  bool BeginChunkScatter(Conn* c, uint64_t payload) {
    Frame& f = c->frame;
    const uint8_t* meta = f.buf + 8ull * f.n_data;
    const uint8_t* ext = FindChunkExt(meta, f.meta_len);
    if (ext == nullptr) return false;
    uint64_t xfer;
    uint32_t index, total;
    uint64_t offset;
    memcpy(&xfer, ext, 8);
    memcpy(&index, ext + kChunkIndexOff, 4);
    memcpy(&total, ext + kChunkTotalOff, 4);
    memcpy(&offset, ext + kChunkOffsetOff, 8);
    uint8_t nseg = ext[kChunkNsegOff];
    if (index == kChunkCompleteIndex || total == 0) return false;
    int sender;
    memcpy(&sender, meta + kMetaSenderOff, 4);
    auto key = std::make_pair(static_cast<long long>(sender),
                              static_cast<unsigned long long>(xfer));
    std::lock_guard<std::mutex> lk(xfers_mu_);
    auto it = xfers_.find(key);
    if (it != xfers_.end() && it->second.dropped) {
      // A rail already declared this transfer inconsistent: consume
      // and discard this stripe too (no reader ref — the entry may
      // reclaim under us otherwise).
      size_t full = c->body_size + payload;
      uint8_t* grown = FramePool::Alloc(full);
      if (grown != nullptr && f.buf != nullptr) {
        memcpy(grown, f.buf, c->body_size);
      }
      FramePool::Release(f.buf);
      f.buf = grown;
      c->drop_frame = true;
      return true;
    }
    if (it == xfers_.end()) {
      if (xfers_.size() >= kMaxXfers) {
        // Evict the stalest partial with no active readers (a sender
        // that died mid-transfer and reconnected would otherwise leak
        // its old entries).
        auto victim = xfers_.end();
        for (auto jt = xfers_.begin(); jt != xfers_.end(); ++jt) {
          if (jt->second.readers > 0) continue;
          if (victim == xfers_.end() ||
              jt->second.seq < victim->second.seq) {
            victim = jt;
          }
        }
        if (victim == xfers_.end()) return false;  // all active
        fprintf(stderr,
                "[pslite_core] W reassembly table full (%zu): evicting "
                "partial xfer %llu from %lld (%u/%u chunks) — the "
                "sender's request deadline will have to recover it\n",
                xfers_.size(),
                static_cast<unsigned long long>(victim->first.second),
                victim->first.first, victim->second.got,
                victim->second.total);
        FramePool::Release(victim->second.buf);
        xfers_.erase(victim);
      }
      ConnXfer x;
      x.total = total;
      x.nseg = nseg;
      x.meta_len = f.meta_len;
      for (uint8_t i = 0; i < nseg; ++i) {
        uint64_t ln;
        memcpy(&ln, ext + kChunkFixedSize + i * kChunkSegEntry, 8);
        x.total_bytes += ln;
      }
      x.body_size = 8ull * nseg + f.meta_len + x.total_bytes;
      x.buf = FramePool::Alloc(x.body_size);
      if (x.buf == nullptr) return false;  // deliver raw, Python copes
      // Lens table of the ORIGINAL segments, then the template meta
      // with the index patched to the completion sentinel.
      for (uint8_t i = 0; i < nseg; ++i) {
        memcpy(x.buf + 8ull * i,
               ext + kChunkFixedSize + i * kChunkSegEntry, 8);
      }
      memcpy(x.buf + 8ull * nseg, meta, f.meta_len);
      size_t ext_off = static_cast<size_t>(ext - meta);
      memcpy(x.buf + 8ull * nseg + ext_off + kChunkIndexOff,
             &kChunkCompleteIndex, 4);
      x.received.assign(total, false);
      x.seq = ++xfer_seq_;
      it = xfers_.emplace(key, std::move(x)).first;
    }
    ConnXfer& x = it->second;
    if (index >= x.total || x.total != total || x.meta_len != f.meta_len ||
        offset + payload > x.total_bytes) {
      // Inconsistent chunk: drop the whole transfer (matching the
      // Python assembler's bounds-check-before-scatter posture) —
      // never deliver a torn payload.  The chunk's payload bytes
      // still have to leave the stream: stage 3 consumes them into
      // the grown frame block and discards the frame.
      fprintf(stderr,
              "[pslite_core] W inconsistent chunk (xfer %llu from %d); "
              "dropping the transfer\n",
              static_cast<unsigned long long>(xfer), sender);
      if (x.readers == 0) {
        FramePool::Release(x.buf);
        xfers_.erase(it);
      } else {
        // Another rail is mid-read into x.buf: the last reader out
        // reclaims (OnPayloadComplete/AbandonScatter).
        x.dropped = true;
      }
      size_t full = c->body_size + payload;
      uint8_t* grown = FramePool::Alloc(full);
      if (grown != nullptr && f.buf != nullptr) {
        memcpy(grown, f.buf, c->body_size);
      }
      FramePool::Release(f.buf);
      f.buf = grown;
      c->drop_frame = true;
      return true;
    }
    // Duplicate index (reassembly runs only with the resender off, so
    // a dup carries identical bytes): rewrite them in place, but do
    // not advance the completion count.
    c->dup_chunk = x.received[index];
    c->pending_index = index;
    c->pending_key = key;
    c->scatter_dst = x.buf + 8ull * x.nseg + x.meta_len + offset;
    x.readers++;
    return true;
  }

  // Pump all available bytes through the frame state machine.  Returns
  // false when the peer closed or errored.
  bool ReadConn(Conn* c) {
    while (true) {
      ssize_t n = read(c->fd, StageDst(c), c->want - c->got);
      wx_rx_syscalls_.fetch_add(1, std::memory_order_relaxed);
      if (n == 0) return false;
      if (n < 0) {
        return errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR;
      }
      // Direct-read scatter (stage 3 into a transfer buffer) is the
      // zero-copy path; everything else stages into a pool block.
      if (c->stage == 3 && c->scatter_dst != nullptr) {
        wx_rx_bytes_zc_.fetch_add(static_cast<uint64_t>(n),
                                  std::memory_order_relaxed);
      } else {
        wx_rx_bytes_copy_.fetch_add(static_cast<uint64_t>(n),
                                    std::memory_order_relaxed);
      }
      c->got += static_cast<size_t>(n);
      // A stage may complete with want == got (empty lens table of a
      // meta-only frame, empty payload) — keep transitioning until the
      // machine wants bytes again (ResetStage always wants a header).
      while (c->got == c->want) {
        if (!OnStageComplete(c)) return false;
      }
    }
  }

  int epfd_;
  int listen_fd_ = -1;
  std::string bound_path_;
  std::thread io_thread_;
  // Extra receive pumps (lazily one per accepted conn, capped by
  // PSL_IO_THREADS): each owns an epoll set.  Primary io thread only.
  std::vector<int> extra_epfds_;
  std::vector<std::thread> io_threads_;
  size_t accept_rr_ = 0;  // primary io thread only
  int max_io_threads_ = 8;
  std::atomic<bool> stopped_{false};
  std::unordered_map<int, Conn*> conns_;  // conns_mu_ (reads io-threads)
  std::mutex conns_mu_;
  std::unordered_map<int, int> send_fds_;
  // Extra per-peer data connections (PS_NATIVE_RAILS).  send_mu_.
  std::unordered_map<int, std::vector<int>> rail_fds_;
  std::atomic<int> rails_{1};
  std::atomic<int> sndbuf_{0};
  std::atomic<int> rcvbuf_{0};
  std::unordered_map<int, WritePipe*> pipes_;                  // send_mu_
  std::unordered_map<std::string, WritePipe*> pipes_by_path_;  // send_mu_
  // Dead-reader pipes parked until shutdown (mapping must outlive any
  // sender blocked inside PipeWriteVec at retirement time).  send_mu_.
  std::vector<WritePipe*> dead_write_pipes_;
  // Lazily read from PS_SHM_RING_DEAD_MS (0 = not yet resolved).
  std::atomic<uint64_t> reader_dead_ms_{0};
  std::vector<std::array<std::string, 3>> watches_;  // pipe_mu_
  std::unordered_map<std::string, ReadPipe*> rpipes_;  // pipe thread only
  std::unordered_map<std::string, uint64_t> bad_pipes_;  // path -> inode
  std::thread pipe_thread_;
  std::mutex pipe_mu_;
  std::atomic<uint64_t> pipe_idle_cap_us_{500};
  std::atomic<int> inflight_sends_{0};
  std::mutex send_mu_;
  std::mutex per_fd_send_mu_[kSendLocks];
  // Per-peer native sender lanes (EnqueueSend/LaneLoop).
  std::unordered_map<int, SendLane*> lanes_;  // lanes_mu_
  std::mutex lanes_mu_;
  std::atomic<uint64_t> ticket_seq_{0};
  std::atomic<long long> pending_descs_{0};
  std::mutex flush_mu_;
  std::condition_variable flush_cv_;
  // Receive-side native reassembly (BeginChunkScatter): enabled by the
  // van when its config is compatible (no resender, no force-order) —
  // chunk-level ACK/ordering layers need to SEE the chunk frames, so
  // they keep the Python assembler.  In-flight transfers are
  // Core-level (xfers_mu_): chunks striped across rails land on
  // different receive pumps but scatter into ONE shared buffer (the
  // payload reads themselves are lock-free — disjoint byte ranges).
  std::atomic<bool> reassemble_{false};
  // Wire-plane observatory counters (StatsSnapshot): relaxed monotonic
  // totals — one cheap fetch_add at each syscall/frame event, mutable
  // so the const snapshot can load them.
  mutable std::atomic<uint64_t> wx_tx_syscalls_{0};
  mutable std::atomic<uint64_t> wx_tx_frames_{0};
  mutable std::atomic<uint64_t> wx_tx_chunks_{0};
  mutable std::atomic<uint64_t> wx_tx_bytes_{0};
  mutable std::atomic<uint64_t> wx_tx_msgs_{0};
  mutable std::atomic<uint64_t> wx_rx_syscalls_{0};
  mutable std::atomic<uint64_t> wx_rx_frames_{0};
  mutable std::atomic<uint64_t> wx_rx_bytes_copy_{0};
  mutable std::atomic<uint64_t> wx_rx_bytes_zc_{0};
  mutable std::atomic<uint64_t> wx_rx_pool_hits_{0};
  mutable std::atomic<uint64_t> wx_rx_pool_misses_{0};
  std::map<std::pair<long long, unsigned long long>, ConnXfer> xfers_;
  uint64_t xfer_seq_ = 0;  // xfers_mu_
  std::mutex xfers_mu_;
  std::deque<Frame> queue_;
  std::deque<Frame> express_;  // priority > 0 data frames pop first
  // PS_RECV_PRIORITY=0 restores the single strict-FIFO queue (process
  // env: the native core is per-process, unlike the per-node Python
  // Environment overrides of the in-process test clusters).
  const bool recv_priority_ = [] {
    const char* v = getenv("PS_RECV_PRIORITY");
    return v == nullptr || strcmp(v, "0") != 0;
  }();
  std::mutex queue_mu_;
  std::condition_variable queue_cv_;
};

// Parallel memcpy pool for the shm van's segment writes — the native
// counterpart of the reference IPC transport's async copy thread pool
// (rdma_transport.h:469-633, BYTEPS_IPC_COPY_NUM_THREADS): multi-MB
// payload copies are split across persistent native threads, GIL-free
// (Python enters through a ctypes call, which releases the GIL).
class CopyPool {
 public:
  explicit CopyPool(int n_threads)
      : n_(n_threads < 1 ? 1 : n_threads) {
    for (int i = 0; i < n_; ++i) {
      threads_.emplace_back([this] { Work(); });
    }
  }

  ~CopyPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  void Copy(uint8_t* dst, const uint8_t* src, uint64_t n) {
    constexpr uint64_t kMinChunk = 1ull << 20;  // below this, inline memcpy
    uint64_t want = n / kMinChunk;
    int parts = static_cast<int>(
        want < 1 ? 1 : (want > static_cast<uint64_t>(n_) + 1
                            ? static_cast<uint64_t>(n_) + 1
                            : want));
    if (parts <= 1) {
      memcpy(dst, src, n);
      return;
    }
    // One job at a time per pool; concurrent callers serialize here.
    std::lock_guard<std::mutex> caller_lk(caller_mu_);
    Job job;
    job.dst = dst;
    job.src = src;
    job.n = n;
    job.parts = parts;
    {
      std::lock_guard<std::mutex> lk(mu_);
      job_ = &job;
      ++seq_;
    }
    cv_.notify_all();
    RunChunks(&job);  // the caller is a worker too
    // The job lives on this stack: wait until every chunk is copied AND
    // every attached worker detached before letting it go out of scope.
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] {
      return job.done.load() == job.parts && job.workers == 0;
    });
    job_ = nullptr;
  }

 private:
  struct Job {
    uint8_t* dst = nullptr;
    const uint8_t* src = nullptr;
    uint64_t n = 0;
    int parts = 0;
    std::atomic<int> next{0};
    std::atomic<int> done{0};
    int workers = 0;  // attached pool threads; guarded by mu_
  };

  void RunChunks(Job* job) {
    int finished = 0;
    for (int i = job->next.fetch_add(1); i < job->parts;
         i = job->next.fetch_add(1)) {
      uint64_t lo = job->n * i / job->parts;
      uint64_t hi = job->n * (i + 1) / job->parts;
      memcpy(job->dst + lo, job->src + lo, hi - lo);
      ++finished;
    }
    if (finished) job->done.fetch_add(finished);
  }

  void Work() {
    uint64_t seen = 0;
    while (true) {
      Job* job = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || seq_ != seen; });
        if (stop_) return;
        seen = seq_;
        job = job_;  // may already be null (job finished without us)
        if (job != nullptr) ++job->workers;
      }
      if (job == nullptr) continue;
      RunChunks(job);
      {
        std::lock_guard<std::mutex> lk(mu_);
        --job->workers;
      }
      done_cv_.notify_all();
    }
  }

  int n_;
  std::vector<std::thread> threads_;
  std::mutex mu_;
  std::mutex caller_mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  Job* job_ = nullptr;
  uint64_t seq_ = 0;
  bool stop_ = false;
};

}  // namespace

// ---- wire codec kernels (docs/compression.md) ------------------------------
//
// Fused single-pass blockwise quantize for the Python codec tier
// (pslite_tpu/ops/codecs.py): one read of the span computes the block
// max AND stages the (optionally EF-folded) values in an L1-resident
// block buffer; the second loop quantizes from L1, writes the 1/4-width
// codes, and updates the error-feedback residual — ~5 bytes of memory
// traffic per element (13 with EF) where the numpy fallback's separate
// abs/max/mul/rint/clip/cast passes move ~40+.  Called per span from
// the codec thread pool (ctypes releases the GIL), so spans scale
// across cores while the caller's Python threads stay responsive.
//
// BIT-IDENTICAL to the numpy fallback by construction: same op order
// (finite-masked block max, scale = max(fmax, 1e-12)/qmax, y = eff *
// (1.0f/scale), rint/clip for int8; clip + f32->f16 RNE + the
// ml_dtypes-derived 64K lookup for fp8), every step an exactly-rounded
// IEEE f32 op — so mixed native/pure-Python clusters produce the same
// wire bytes (asserted in tests/test_ops.py).

namespace {

uint8_t g_fp8_enc_lut[65536];
float g_fp8_dec_lut[256];
std::atomic<int> g_fp8_tables_ready{0};

// Software f32 -> f16 bit conversion, exact round-to-nearest-even for
// normal f16 results.  Values below the f16 normal range all map to
// e4m3 code 0 through the lookup (e4m3's smallest nonzero is 2^-9, and
// ties round even at 2^-10), so sub-subnormal rounding minutiae cannot
// change the emitted byte — see the parity test.
inline uint16_t F32ToF16Bits(float f) {
  uint32_t x;
  memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  uint32_t exp = (x >> 23) & 0xFFu;
  uint32_t man = x & 0x7FFFFFu;
  if (exp == 0xFFu) {  // inf / nan
    return static_cast<uint16_t>(
        sign | 0x7C00u | (man ? (0x0200u | (man >> 13)) : 0));
  }
  int32_t e = static_cast<int32_t>(exp) - 127 + 15;
  if (e >= 31) return static_cast<uint16_t>(sign | 0x7C00u);  // -> inf
  if (e <= 0) return static_cast<uint16_t>(sign);  // below e4m3 range
  uint16_t h = static_cast<uint16_t>(sign | (static_cast<uint32_t>(e) << 10) |
                                     (man >> 13));
  uint32_t rem = man & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (h & 1u))) ++h;  // RNE (carry ok)
  return h;
}

constexpr uint64_t kCodecMaxBlock = 1024;

#if defined(__x86_64__)
__attribute__((target("f16c")))
void F32ToF16SpanF16C(const float* src, uint16_t* dst, uint64_t m) {
  uint64_t i = 0;
  for (; i + 8 <= m; i += 8) {
    __m256 v = _mm256_loadu_ps(src + i);
    __m128i h =
        _mm256_cvtps_ph(v, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + i), h);
  }
  for (; i < m; ++i) dst[i] = F32ToF16Bits(src[i]);
}
#endif

// Hardware vs software f32->f16: identical FINAL e4m3 bytes either way
// — normals round RNE in both, every f16 subnormal result maps to
// e4m3 code 0 through the lookup, and all NaN payloads collapse onto
// the single e4m3fn NaN — so runtime dispatch cannot break the
// mixed-cluster bit-exactness contract.
// Persistent worker pool for the codec kernels: the Python tier makes
// ONE ctypes call per payload (GIL released once) and the spans fan
// out on C++ threads — dispatching spans from Python instead pays a
// GIL handoff per span, which under a busy receive pump stretches a
// ~2 ms decode into tens of ms (measured via the trace tier).
class CodecSpanPool {
 public:
  static CodecSpanPool& Get() {
    static CodecSpanPool* p = new CodecSpanPool();
    return *p;
  }

  // Run fn over block-aligned spans of [0, n); serializes concurrent
  // callers (they would only fight for memory bandwidth anyway).
  void Run(uint64_t n, uint64_t block, int nthreads,
           const std::function<void(uint64_t, uint64_t)>& fn) {
    if (nthreads <= 1 || n * 4 < (1u << 21)) {
      fn(0, n);
      return;
    }
    std::lock_guard<std::mutex> run_lk(run_mu_);
    std::unique_lock<std::mutex> lk(mu_);
    EnsureThreadsLocked(nthreads - 1);  // caller works too
    const uint64_t blocks = (n + block - 1) / block;
    const uint64_t per =
        (blocks + static_cast<uint64_t>(nthreads) - 1) / nthreads * block;
    spans_.clear();
    for (uint64_t a = 0; a < n; a += per)
      spans_.emplace_back(a, std::min(a + per, n));
    fn_ = &fn;
    next_ = 0;
    remaining_ = spans_.size();
    cv_.notify_all();
    // The caller drains spans alongside the workers.
    DrainLocked(lk);
    done_cv_.wait(lk, [&] { return remaining_ == 0; });
    fn_ = nullptr;
  }

 private:
  void EnsureThreadsLocked(int n) {
    while (static_cast<int>(threads_.size()) < n) {
      threads_.emplace_back([this] { Loop(); });
      threads_.back().detach();
    }
  }

  void DrainLocked(std::unique_lock<std::mutex>& lk) {
    while (fn_ && next_ < spans_.size()) {
      const auto span = spans_[next_++];
      const auto* fn = fn_;
      lk.unlock();
      (*fn)(span.first, span.second);
      lk.lock();
      if (--remaining_ == 0) done_cv_.notify_all();
    }
  }

  void Loop() {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      cv_.wait(lk, [&] { return fn_ && next_ < spans_.size(); });
      DrainLocked(lk);
    }
  }

  std::mutex run_mu_;  // one payload at a time
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::vector<std::thread> threads_;
  std::vector<std::pair<uint64_t, uint64_t>> spans_;
  const std::function<void(uint64_t, uint64_t)>* fn_ = nullptr;
  size_t next_ = 0;
  size_t remaining_ = 0;
};

#if defined(__x86_64__)
inline bool CpuHasF16C() {
  unsigned int eax = 0, ebx = 0, ecx = 0, edx = 0;
  if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
  return (ecx >> 29) & 1u;  // CPUID.1:ECX.F16C
}
#endif

inline void F32ToF16Span(const float* src, uint16_t* dst, uint64_t m) {
#if defined(__x86_64__)
  static const bool kHasF16C = CpuHasF16C();
  if (kHasF16C) {
    F32ToF16SpanF16C(src, dst, m);
    return;
  }
#endif
  for (uint64_t i = 0; i < m; ++i) dst[i] = F32ToF16Bits(src[i]);
}

}  // namespace

// pslite_tpu_torch: built with -fvisibility=hidden, so only the C API
// below is exported.  The JAX package's libpslite_core.so and this one
// load into one process (the port's tests do that) without either
// interposing on the other's psl_* entry points or inline symbols.
#pragma GCC visibility push(default)
extern "C" {

struct psl_frame_view {
  uint8_t* buf;
  uint32_t meta_len;
  uint32_t n_data;
};

void* psl_create() { return new Core(); }

int psl_bind(void* h, int port, int backlog) {
  return static_cast<Core*>(h)->Bind(port, backlog);
}

int psl_connect(void* h, int node_id, const char* host, int port,
                int timeout_ms) {
  return static_cast<Core*>(h)->Connect(node_id, host, port, timeout_ms);
}

int psl_bind_local(void* h, const char* path, int backlog) {
  return static_cast<Core*>(h)->BindLocal(path, backlog);
}

int psl_pipe_connect(void* h, int node_id, const char* path,
                     uint64_t data_bytes) {
  return static_cast<Core*>(h)->PipeConnect(node_id, path, data_bytes);
}

int psl_pipe_watch(void* h, const char* dir, const char* prefix,
                   const char* suffix, int idle_cap_us) {
  return static_cast<Core*>(h)->PipeWatch(dir, prefix, suffix, idle_cap_us);
}

int psl_connect_local(void* h, int node_id, const char* path,
                      int timeout_ms) {
  return static_cast<Core*>(h)->ConnectLocal(node_id, path, timeout_ms);
}

long long psl_send(void* h, int node_id, const uint8_t* meta,
                   uint32_t meta_len, uint32_t n_data,
                   const uint8_t* const* data, const uint64_t* lens) {
  return static_cast<Core*>(h)->Send(node_id, meta, meta_len, n_data, data,
                                     lens);
}

int psl_abi_version() { return kAbiVersion; }

// Wire-plane observatory (docs/observability.md): fill the caller's
// counter block in one call.  Returns the struct size actually
// written, so a caller built against a newer layout can detect a
// short (older) library without a separate version probe.
int psl_stats_snapshot(void* h, psl_wire_stats* out) {
  static_cast<Core*>(h)->StatsSnapshot(out);
  return static_cast<int>(sizeof(psl_wire_stats));
}

long long psl_send_enqueue(void* h, int node_id, int priority,
                           const uint8_t* meta, uint32_t meta_len,
                           uint32_t n_data, const uint8_t* const* data,
                           const uint64_t* lens, uint64_t chunk_bytes,
                           int32_t chunk_ext_off) {
  return static_cast<Core*>(h)->EnqueueSend(node_id, priority, meta,
                                            meta_len, n_data, data, lens,
                                            chunk_bytes, chunk_ext_off);
}

int psl_send_reap(void* h, int node_id, uint64_t* tickets, long long* status,
                  int cap) {
  return static_cast<Core*>(h)->SendReap(node_id, tickets, status, cap);
}

int psl_send_flush(void* h, int timeout_ms) {
  return static_cast<Core*>(h)->SendFlush(timeout_ms);
}

long long psl_send_cancel(void* h, int node_id) {
  return static_cast<Core*>(h)->SendCancel(node_id);
}

void psl_send_reset_sid(void* h, int node_id) {
  static_cast<Core*>(h)->SendResetSid(node_id);
}

void psl_set_reassembly(void* h, int on) {
  static_cast<Core*>(h)->SetReassembly(on);
}

// Multi-rail data plane (PS_NATIVE_RAILS, docs/native_core.md): call
// psl_set_rails BEFORE the first data send (rail threads spawn with
// the lane; receive pumps spawn per accepted conn, rail-agnostic);
// psl_add_rail dials rail `idx` (1-based) to a peer.  psl_set_sockbuf
// mirrors the Python van's PS_TCP_SNDBUF/PS_TCP_RCVBUF bounds onto
// native sockets.
void psl_set_rails(void* h, int n) { static_cast<Core*>(h)->SetRails(n); }

int psl_add_rail(void* h, int node_id, const char* host, int port,
                 int timeout_ms, int idx) {
  return static_cast<Core*>(h)->AddRail(node_id, host, port, timeout_ms,
                                        idx);
}

void psl_set_sockbuf(void* h, int snd, int rcv) {
  static_cast<Core*>(h)->SetSockBuf(snd, rcv);
}

int psl_recv(void* h, psl_frame_view* out, int timeout_ms) {
  Frame f;
  int rc = static_cast<Core*>(h)->Recv(&f, timeout_ms);
  if (rc == 1) {
    out->buf = f.buf;
    out->meta_len = f.meta_len;
    out->n_data = f.n_data;
  }
  return rc;
}

void psl_frame_free(uint8_t* buf) { FramePool::Release(buf); }

// Single-shot GIL-free kernels for the RECEIVE-side Python hot loops
// (docs/native_core.md): ctypes releases the GIL around CDLL calls, so
// routing the chunk-scatter memcpy and the server's in-place apply add
// through these lets the van-recv thread, the apply shard threads, and
// the meta decoder stream concurrently instead of serializing on one
// GIL (numpy's copy/ufunc paths hold it).  The adds are plain
// element-wise IEEE ops — results are bit-identical to numpy's
// same-dtype in-place add, so enabling/disabling the native path can
// never change stored values.
void psl_memcpy(void* dst, const void* src, uint64_t n) {
  memcpy(dst, src, n);
}

void psl_iadd_f32(float* dst, const float* src, uint64_t n) {
  for (uint64_t i = 0; i < n; ++i) dst[i] += src[i];
}

// Register the fp8_e4m3fn lookup tables (built Python-side from
// ml_dtypes so both planes share ONE rounding definition): enc maps a
// f16 bit pattern to the e4m3 byte, dec maps the byte back to f32.
void psl_codec_set_fp8_tables(const uint8_t* enc, const float* dec) {
  memcpy(g_fp8_enc_lut, enc, sizeof(g_fp8_enc_lut));
  memcpy(g_fp8_dec_lut, dec, sizeof(g_fp8_dec_lut));
  g_fp8_tables_ready.store(1, std::memory_order_release);
}

// Encode one block-aligned span: kind 0 = int8 (NaN -> reserved -128,
// reported in the returned flag bit 1), kind 1 = fp8_e4m3fn (NaN is a
// native encoding).  ``resid`` (nullable) fuses error feedback: the
// effective value is x + resid and resid is left holding the new
// quantization error (0 where the input was non-finite).  Returns the
// flag bits, or -1 when this call cannot run natively (unsupported
// block / fp8 tables not registered) and the caller must take the
// numpy fallback.
int psl_codec_encode(int kind, const float* x, float* resid, uint64_t n,
                     uint64_t block, uint8_t* codes, float* scales) {
  if (block == 0 || block > kCodecMaxBlock) return -1;
  if (kind != 0 && kind != 1) return -1;
  if (kind == 1 && !g_fp8_tables_ready.load(std::memory_order_acquire))
    return -1;
  const float qmax = (kind == 1) ? 448.0f : 127.0f;
  int flags = 0;
  float eff[kCodecMaxBlock];
  for (uint64_t b0 = 0; b0 < n; b0 += block) {
    const uint64_t m = (n - b0 < block) ? (n - b0) : block;
    const float* xs = x + b0;
    float* rs = resid ? resid + b0 : nullptr;
    float fmax = 0.0f;
    for (uint64_t i = 0; i < m; ++i) {
      const float e = rs ? xs[i] + rs[i] : xs[i];
      eff[i] = e;
      const float a = fabsf(e);
      if (std::isfinite(a) && a > fmax) fmax = a;  // finite-masked max
    }
    const float scale = ((fmax > 1e-12f) ? fmax : 1e-12f) / qmax;
    const float inv = 1.0f / scale;
    scales[b0 / block] = scale;
    uint8_t* cs = codes + b0;
    if (kind == 0) {
      for (uint64_t i = 0; i < m; ++i) {
        const float q = rintf(eff[i] * inv);  // RNE, same as np.rint
        int8_t c;
        if (std::isnan(q)) {
          c = -128;
          flags |= 1;
        } else if (q > 127.0f) {
          c = 127;
        } else if (q < -127.0f) {
          c = -127;
        } else {
          c = static_cast<int8_t>(q);
        }
        cs[i] = static_cast<uint8_t>(c);
        if (rs) {
          // Matches the numpy EF path: reconstruct (the -128 sentinel
          // decodes as -128*scale there too) and zero non-finite
          // error so NaN/Inf inputs cannot poison later rounds.
          const float r2 = eff[i] - static_cast<float>(c) * scale;
          rs[i] = std::isfinite(r2) ? r2 : 0.0f;
        }
      }
    } else {
      float y[kCodecMaxBlock];
      uint16_t h16[kCodecMaxBlock];
      for (uint64_t i = 0; i < m; ++i) {
        float v = eff[i] * inv;
        if (v > 448.0f) {
          v = 448.0f;  // +/-Inf saturates; NaN falls through (np.clip)
        } else if (v < -448.0f) {
          v = -448.0f;
        }
        y[i] = v;
      }
      F32ToF16Span(y, h16, m);
      if (rs) {
        for (uint64_t i = 0; i < m; ++i) {
          const uint8_t c = g_fp8_enc_lut[h16[i]];
          cs[i] = c;
          const float r2 = eff[i] - g_fp8_dec_lut[c] * scale;
          rs[i] = std::isfinite(r2) ? r2 : 0.0f;
        }
      } else {
        for (uint64_t i = 0; i < m; ++i) cs[i] = g_fp8_enc_lut[h16[i]];
      }
    }
  }
  return flags;
}

// Decode one block-aligned span (inverse of psl_codec_encode; the
// int8 NaN sentinel is honored only when the encode flagged it, like
// the numpy decode).  Returns -1 -> caller falls back to numpy.
int psl_codec_decode(int kind, const uint8_t* codes, const float* scales,
                     uint64_t n, uint64_t block, int flags, float* out) {
  if (block == 0 || block > kCodecMaxBlock) return -1;
  if (kind != 0 && kind != 1) return -1;
  if (kind == 1 && !g_fp8_tables_ready.load(std::memory_order_acquire))
    return -1;
  for (uint64_t b0 = 0; b0 < n; b0 += block) {
    const uint64_t m = (n - b0 < block) ? (n - b0) : block;
    const float scale = scales[b0 / block];
    const uint8_t* cs = codes + b0;
    float* os = out + b0;
    if (kind == 0) {
      if (flags & 1) {
        for (uint64_t i = 0; i < m; ++i) {
          const int8_t c = static_cast<int8_t>(cs[i]);
          os[i] = (c == -128) ? NAN : static_cast<float>(c) * scale;
        }
      } else {
        for (uint64_t i = 0; i < m; ++i) {
          os[i] = static_cast<float>(static_cast<int8_t>(cs[i])) * scale;
        }
      }
    } else {
      for (uint64_t i = 0; i < m; ++i) {
        os[i] = g_fp8_dec_lut[cs[i]] * scale;
      }
    }
  }
  return 0;
}

// Whole-payload variants: ONE call from Python (one GIL release), the
// block-aligned span fan-out runs on the persistent CodecSpanPool —
// span boundaries never straddle a scale block, so the output is
// bit-identical to the single-threaded call for every thread count.
int psl_codec_encode_mt(int kind, const float* x, float* resid, uint64_t n,
                        uint64_t block, uint8_t* codes, float* scales,
                        int nthreads) {
  if (block == 0 || block > kCodecMaxBlock) return -1;
  if (kind != 0 && kind != 1) return -1;
  if (kind == 1 && !g_fp8_tables_ready.load(std::memory_order_acquire))
    return -1;
  std::atomic<int> flags{0};
  CodecSpanPool::Get().Run(n, block, nthreads,
                           [&](uint64_t a, uint64_t b) {
    const int f =
        psl_codec_encode(kind, x + a, resid ? resid + a : nullptr, b - a,
                         block, codes + a, scales + a / block);
    if (f > 0) flags.fetch_or(f, std::memory_order_relaxed);
  });
  return flags.load();
}

// Decode arbitrary element ranges of a payload (scales indexed by
// GLOBAL element position, so ranges need not align to scale blocks):
// the server's apply shards decode only their own keys' segments, in
// parallel on the shard threads, instead of serializing one whole-
// payload decode on the receive pump.  Output is written back to back
// in range order; values are bit-identical to the full decode.
int psl_codec_decode_ranges(int kind, const uint8_t* codes,
                            const float* scales, const uint64_t* starts,
                            const uint64_t* ends, int nranges,
                            uint64_t block, int flags, float* out) {
  if (block == 0) return -1;
  if (kind != 0 && kind != 1) return -1;
  if (kind == 1 && !g_fp8_tables_ready.load(std::memory_order_acquire))
    return -1;
  uint64_t off = 0;
  for (int r = 0; r < nranges; ++r) {
    uint64_t j = starts[r];
    const uint64_t e = ends[r];
    while (j < e) {
      // One scale block at a time: hoists the j/block divide out of
      // the element loop.
      const uint64_t bend = std::min(e, (j / block + 1) * block);
      const float scale = scales[j / block];
      if (kind == 0) {
        if (flags & 1) {
          for (; j < bend; ++j, ++off) {
            const int8_t c = static_cast<int8_t>(codes[j]);
            out[off] = (c == -128) ? NAN : static_cast<float>(c) * scale;
          }
        } else {
          for (; j < bend; ++j, ++off)
            out[off] = static_cast<float>(static_cast<int8_t>(codes[j]))
                       * scale;
        }
      } else {
        for (; j < bend; ++j, ++off) out[off] = g_fp8_dec_lut[codes[j]] * scale;
      }
    }
  }
  return 0;
}

int psl_codec_decode_mt(int kind, const uint8_t* codes, const float* scales,
                        uint64_t n, uint64_t block, int flags, float* out,
                        int nthreads) {
  if (block == 0 || block > kCodecMaxBlock) return -1;
  if (kind != 0 && kind != 1) return -1;
  if (kind == 1 && !g_fp8_tables_ready.load(std::memory_order_acquire))
    return -1;
  CodecSpanPool::Get().Run(n, block, nthreads,
                           [&](uint64_t a, uint64_t b) {
    psl_codec_decode(kind, codes + a, scales + a / block, b - a, block,
                     flags, out + a);
  });
  return 0;
}

void psl_iadd_f64(double* dst, const double* src, uint64_t n) {
  for (uint64_t i = 0; i < n; ++i) dst[i] += src[i];
}

void* psl_copy_pool_create(int n_threads) { return new CopyPool(n_threads); }

void psl_copy_pool_copy(void* p, void* dst, const void* src, uint64_t n) {
  static_cast<CopyPool*>(p)->Copy(static_cast<uint8_t*>(dst),
                                  static_cast<const uint8_t*>(src), n);
}

void psl_copy_pool_destroy(void* p) { delete static_cast<CopyPool*>(p); }

void psl_stop(void* h) { static_cast<Core*>(h)->Stop(); }

void psl_destroy(void* h) { delete static_cast<Core*>(h); }

}  // extern "C"
#pragma GCC visibility pop  // pslite_tpu_torch: see the push above
