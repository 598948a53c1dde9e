// Native FSM token-mask matcher for constrained decoding (the port's copy of
// opsagent_tpu/native/fsm_matcher.cc, with the destination-row copy added).
//
// serving/constrained.py's TokenFSM walks a byte DFA over the vocabulary
// with vectorized numpy, one state at a time. This C++ component
// precomputes the full [num_states x vocab] mask table and the
// [num_states x vocab] destination table eagerly, one state per worker
// thread at a time, so a host mask or an advance costs a row copy or a
// lookup.
//
// Exposed as a flat C ABI for ctypes. All memory is owned by the handle;
// the Python side copies rows out.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct FsmTables {
  int32_t num_states = 0;
  int32_t vocab = 0;
  int32_t words_per_row = 0;           // 64-bit words per mask row
  std::vector<uint64_t> masks;         // [num_states][words_per_row]
  std::vector<int32_t> dest;           // [num_states][vocab], -1 = dead
  std::vector<uint8_t> accept;         // [num_states]
};

// Walk one token's bytes from `state`; returns final state or -1.
inline int32_t run_bytes(const int32_t* dfa_next, int32_t state,
                         const uint8_t* bytes, int32_t len) {
  for (int32_t j = 0; j < len; ++j) {
    state = dfa_next[static_cast<int64_t>(state) * 256 + bytes[j]];
    if (state < 0) return -1;
  }
  return state;
}

}  // namespace

extern "C" {

// Build the full tables.
//   dfa_next:      [num_states * 256] int32, -1 = dead
//   dfa_accept:    [num_states] uint8
//   token_bytes:   concatenated token byte strings
//   token_offsets: [vocab + 1] int32 offsets into token_bytes
//   eos_id:        token admissible exactly in accepting states
//   num_threads:   0 = hardware concurrency
void* opsagent_fsm_build(const int32_t* dfa_next, const uint8_t* dfa_accept,
                         int32_t num_states, const uint8_t* token_bytes,
                         const int32_t* token_offsets, int32_t vocab,
                         int32_t eos_id, int32_t num_threads) {
  auto* t = new FsmTables();
  t->num_states = num_states;
  t->vocab = vocab;
  t->words_per_row = (vocab + 63) / 64;
  t->masks.assign(static_cast<size_t>(num_states) * t->words_per_row, 0);
  t->dest.assign(static_cast<size_t>(num_states) * vocab, -1);
  t->accept.assign(dfa_accept, dfa_accept + num_states);

  int n_threads = num_threads > 0
                      ? num_threads
                      : static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;

  std::atomic<int32_t> next_state{0};
  auto worker = [&]() {
    for (;;) {
      int32_t s = next_state.fetch_add(1);
      if (s >= num_states) return;
      uint64_t* mask_row = &t->masks[static_cast<size_t>(s) * t->words_per_row];
      int32_t* dest_row = &t->dest[static_cast<size_t>(s) * vocab];
      for (int32_t tok = 0; tok < vocab; ++tok) {
        int32_t off = token_offsets[tok];
        int32_t len = token_offsets[tok + 1] - off;
        if (len == 0) {
          // Special token (no output bytes): never admissible via the mask,
          // but advancing over it leaves the state unchanged — matching the
          // Python dfa.run(state, b"") semantics.
          dest_row[tok] = s;
          continue;
        }
        int32_t end = run_bytes(dfa_next, s, token_bytes + off, len);
        dest_row[tok] = end;
        if (end >= 0) mask_row[tok >> 6] |= (1ULL << (tok & 63));
      }
      if (t->accept[s] && eos_id >= 0 && eos_id < vocab) {
        mask_row[eos_id >> 6] |= (1ULL << (eos_id & 63));
      }
    }
  };
  std::vector<std::thread> threads;
  for (int i = 0; i < n_threads; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return t;
}

int32_t opsagent_fsm_num_states(void* handle) {
  return static_cast<FsmTables*>(handle)->num_states;
}

// Copy state's mask row as unpacked bytes (0/1) into out[vocab].
void opsagent_fsm_mask(void* handle, int32_t state, uint8_t* out) {
  auto* t = static_cast<FsmTables*>(handle);
  if (state < 0 || state >= t->num_states) {
    std::memset(out, 0, t->vocab);
    return;
  }
  const uint64_t* row = &t->masks[static_cast<size_t>(state) * t->words_per_row];
  for (int32_t tok = 0; tok < t->vocab; ++tok) {
    out[tok] = (row[tok >> 6] >> (tok & 63)) & 1;
  }
}

// Advance by one token id; -1 if dead/invalid.
int32_t opsagent_fsm_advance(void* handle, int32_t state, int32_t token) {
  auto* t = static_cast<FsmTables*>(handle);
  if (state < 0 || state >= t->num_states || token < 0 || token >= t->vocab)
    return -1;
  return t->dest[static_cast<size_t>(state) * t->vocab + token];
}

// Copy state's destination row (the DFA state each token ends in, -1 =
// dead; an empty token keeps the state) into out[vocab].
void opsagent_fsm_dest(void* handle, int32_t state, int32_t* out) {
  auto* t = static_cast<FsmTables*>(handle);
  if (state < 0 || state >= t->num_states) {
    for (int32_t tok = 0; tok < t->vocab; ++tok) out[tok] = -1;
    return;
  }
  std::memcpy(out, &t->dest[static_cast<size_t>(state) * t->vocab],
              sizeof(int32_t) * static_cast<size_t>(t->vocab));
}

void opsagent_fsm_free(void* handle) { delete static_cast<FsmTables*>(handle); }

}  // extern "C"
