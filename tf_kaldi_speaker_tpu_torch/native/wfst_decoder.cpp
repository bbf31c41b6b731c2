// Native WFST beam decoder for the multitask phone head.
//
// The reference decodes its hybrid acoustic model with the external Kaldi
// binary `latgen-faster-mapped` (reference nnet/run_decode.sh:77-91): HCLG
// graph + per-frame pdf log-likelihoods -> word sequence. This library
// re-provides the decode natively: an OpenFst reader (vector/const fsts,
// tropical StdArc — the HCLG on-disk formats) and a token-passing Viterbi
// beam search with epsilon closure and max-active pruning, equivalent to
// Kaldi's faster-decoder followed by best-path extraction ("mapped" =
// graph ilabels are transition-ids, scored through a tid->pdf map).
//
// Exposed C ABI (ctypes from backend/decoder.py; GIL is released during
// calls, so Python-level thread pools parallelize across utterances):
//   void*   tfks_fst_load(path)             -> handle or NULL
//   void    tfks_fst_free(handle)
//   int64_t tfks_fst_states(handle), tfks_fst_arcs(handle),
//           tfks_fst_start(handle)
//   int     tfks_fst_validate(handle, tid2pdf, num_tids, num_pdfs)
//     -> 0 if every emitting ilabel maps into the loglike matrix; run once
//        per (graph, model) instead of scanning all arcs per utterance
//   void*   tfks_decoder_new(fst_handle)    -> reusable decoder context
//           (NOT thread-safe: one context per thread; the fst handle must
//           outlive its decoders). Amortizes the O(num_states) token-index
//           allocation across utterances.
//   void    tfks_decoder_free(ctx)
//   int     tfks_decode_faster(ctx, loglikes[T*P], T, P,
//               tid2pdf[num_tids], num_tids, acoustic_scale, beam,
//               max_active, out_words, cap_words, out_align, cap_align,
//               out_nwords, out_nalign, out_cost)
//     -> 0 full path, 1 partial path (no final state reached),
//        negative TFKS_ERR_* on failure (TFKS_ERR_CAPACITY: retry with a
//        larger out_words/out_align buffer)
//   int     tfks_decode_lattice(ctx, loglikes[T*P], T, P, tid2pdf,
//               num_tids, acoustic_scale, beam, lattice_beam, max_active,
//               out_arcs[4*cap_arcs], out_arc_costs[2*cap_arcs], cap_arcs,
//               out_finals[cap_finals], out_final_costs[cap_finals],
//               cap_finals, out_narcs, out_nfinals, out_nstates, out_start)
//     -> pruned raw lattice (latgen-faster-mapped semantics); arcs are
//        (src,dst,ilabel,olabel) int32 quads with (graph, UNSCALED
//        acoustic) cost pairs; same 0/1/negative return convention

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

#define TFKS_ERR_IO -1
#define TFKS_ERR_FORMAT -2
#define TFKS_ERR_CAPACITY -3
#define TFKS_ERR_EMPTY -4
#define TFKS_ERR_LABEL -5

namespace {

constexpr int32_t kFstMagic = 2125659606;
constexpr int32_t kSymbolTableMagic = 2125658996;
constexpr float kInf = std::numeric_limits<float>::infinity();

struct Fst {
  int64_t start = -1;
  std::vector<float> final_w;      // [nstates], +inf = non-final
  std::vector<int64_t> offsets;    // [nstates+1] CSR
  std::vector<int32_t> ilabels, olabels, nextstates;
  std::vector<float> weights;
};

struct Reader {
  const uint8_t *p, *end;
  bool ok = true;
  bool read(void *out, size_t n) {
    if (p + n > end) { ok = false; return false; }
    std::memcpy(out, p, n);
    p += n;
    return true;
  }
  bool skip(size_t n) {
    if (p + n > end) { ok = false; return false; }
    p += n;
    return true;
  }
  template <typename T> T get() {
    T v{};
    read(&v, sizeof(T));
    return v;
  }
  bool read_string(std::string *s) {
    int32_t n = get<int32_t>();
    if (!ok || n < 0 || n > (1 << 20) || p + n > end) { ok = false; return false; }
    s->assign(reinterpret_cast<const char *>(p), n);
    p += n;
    return true;
  }
  bool align(const uint8_t *base, size_t alignment) {
    size_t pos = static_cast<size_t>(p - base);
    size_t pad = (alignment - pos % alignment) % alignment;
    return skip(pad);
  }
};

bool skip_symbol_table(Reader &r) {
  if (r.get<int32_t>() != kSymbolTableMagic || !r.ok) return false;
  std::string name;
  if (!r.read_string(&name)) return false;
  r.get<int64_t>();  // available key
  int64_t size = r.get<int64_t>();
  if (!r.ok || size < 0) return false;
  for (int64_t i = 0; i < size; ++i) {
    std::string sym;
    if (!r.read_string(&sym)) return false;
    r.get<int64_t>();
  }
  return r.ok;
}

#pragma pack(push, 1)
struct RawArc {
  int32_t ilabel, olabel;
  float weight;
  int32_t nextstate;
};
struct ConstState {
  float final_w;
  uint32_t pos, narcs, niepsilons, noepsilons;
};
#pragma pack(pop)
static_assert(sizeof(RawArc) == 16, "arc layout");
static_assert(sizeof(ConstState) == 20, "const state layout");

Fst *load_fst(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  if (size <= 0 || std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  Reader r{buf.data(), buf.data() + buf.size()};
  if (r.get<int32_t>() != kFstMagic || !r.ok) return nullptr;
  std::string fsttype, arctype;
  if (!r.read_string(&fsttype) || !r.read_string(&arctype)) return nullptr;
  if (arctype != "standard") return nullptr;
  int32_t version = r.get<int32_t>();
  int32_t flags = r.get<int32_t>();
  r.get<uint64_t>();  // properties
  int64_t start = r.get<int64_t>();
  int64_t nstates = r.get<int64_t>();
  int64_t narcs = r.get<int64_t>();
  if (!r.ok || nstates < 0) return nullptr;
  if ((flags & 1) && !skip_symbol_table(r)) return nullptr;
  if ((flags & 2) && !skip_symbol_table(r)) return nullptr;

  auto fst = new Fst();
  fst->start = start;
  fst->final_w.resize(nstates);
  fst->offsets.assign(nstates + 1, 0);

  if (fsttype == "vector") {
    if (version < 2) { delete fst; return nullptr; }
    std::vector<RawArc> arcs;
    if (narcs > 0) arcs.reserve(narcs);
    for (int64_t s = 0; s < nstates; ++s) {
      fst->final_w[s] = r.get<float>();
      int64_t n = r.get<int64_t>();
      if (!r.ok || n < 0) { delete fst; return nullptr; }
      size_t base = arcs.size();
      arcs.resize(base + n);
      if (n && !r.read(arcs.data() + base, n * sizeof(RawArc))) {
        delete fst;
        return nullptr;
      }
      fst->offsets[s + 1] = static_cast<int64_t>(arcs.size());
    }
    int64_t total = fst->offsets[nstates];
    fst->ilabels.resize(total);
    fst->olabels.resize(total);
    fst->weights.resize(total);
    fst->nextstates.resize(total);
    for (int64_t i = 0; i < total; ++i) {
      fst->ilabels[i] = arcs[i].ilabel;
      fst->olabels[i] = arcs[i].olabel;
      fst->weights[i] = arcs[i].weight;
      fst->nextstates[i] = arcs[i].nextstate;
    }
  } else if (fsttype == "const") {
    if (version != 1 && version != 2) { delete fst; return nullptr; }
    if (narcs < 0) { delete fst; return nullptr; }
    bool aligned = version == 1;
    if (aligned && !r.align(buf.data(), 16)) { delete fst; return nullptr; }
    std::vector<ConstState> states(nstates);
    if (nstates && !r.read(states.data(), nstates * sizeof(ConstState))) {
      delete fst;
      return nullptr;
    }
    if (aligned && !r.align(buf.data(), 16)) { delete fst; return nullptr; }
    std::vector<RawArc> arcs(narcs);
    if (narcs && !r.read(arcs.data(), narcs * sizeof(RawArc))) {
      delete fst;
      return nullptr;
    }
    fst->ilabels.resize(narcs);
    fst->olabels.resize(narcs);
    fst->weights.resize(narcs);
    fst->nextstates.resize(narcs);
    int64_t w = 0;
    for (int64_t s = 0; s < nstates; ++s) {
      fst->final_w[s] = states[s].final_w;
      int64_t pos = states[s].pos, n = states[s].narcs;
      if (pos < 0 || pos + n > narcs) { delete fst; return nullptr; }
      for (int64_t i = 0; i < n; ++i, ++w) {
        const RawArc &a = arcs[pos + i];
        fst->ilabels[w] = a.ilabel;
        fst->olabels[w] = a.olabel;
        fst->weights[w] = a.weight;
        fst->nextstates[w] = a.nextstate;
      }
      fst->offsets[s + 1] = w;
    }
  } else {
    delete fst;
    return nullptr;
  }
  // Validate arc targets and labels once at load so the decode hot loop
  // can skip bounds checks.
  for (int32_t ns : fst->nextstates) {
    if (ns < 0 || ns >= nstates) { delete fst; return nullptr; }
  }
  return fst;
}

// ---------------------------------------------------------------------------
// Token-passing Viterbi beam search (Kaldi faster-decoder semantics).

struct BackPtr {
  int32_t prev;    // index into the arena, -1 at origin
  int32_t ilabel;  // >0 consumed a frame (transition-id)
  int32_t olabel;  // >0 emits a word
};

struct Token {
  int32_t state;
  float cost;
  int32_t bp;  // arena index, -1 for the initial token
};

class Decoder {
 public:
  explicit Decoder(const Fst &fst) : fst_(fst), tok_idx_(fst.final_w.size(), -1) {}

  // Returns 0 (full), 1 (partial) or a negative error. Label validity
  // (every emitting ilabel maps into the loglike matrix) is checked once
  // per (graph, model) via tfks_fst_validate, not per utterance.
  int Decode(const float *loglikes, int32_t num_frames, int32_t num_pdfs,
             const int32_t *tid2pdf, int32_t num_tids, float acoustic_scale,
             float beam, int32_t max_active, std::vector<int32_t> *words,
             std::vector<int32_t> *alignment, float *total_cost) {
    if (fst_.start < 0) return TFKS_ERR_EMPTY;

    arena_.clear();
    cur_.clear();
    // tok_idx_ was initialized to -1 at construction; reset only the
    // entries the previous utterance touched (the context is reused
    // across utterances to amortize the O(num_states) allocation).
    for (int32_t s : touched_) tok_idx_[s] = -1;
    touched_.clear();
    cur_.push_back({static_cast<int32_t>(fst_.start), 0.0f, -1});
    tok_idx_[fst_.start] = 0;
    touched_.push_back(static_cast<int32_t>(fst_.start));
    ProcessNonemitting(beam);

    for (int32_t t = 0; t < num_frames; ++t) {
      const float *frame = loglikes + static_cast<int64_t>(t) * num_pdfs;
      float cutoff = GetCutoff(beam, max_active);
      next_.clear();
      // Swap index ownership: from here tok_idx_ indexes next_.
      for (int32_t s : touched_) tok_idx_[s] = -1;
      touched_.clear();
      float next_best = kInf;
      for (const Token &tok : cur_) {
        if (tok.cost > cutoff) continue;
        int64_t lo = fst_.offsets[tok.state], hi = fst_.offsets[tok.state + 1];
        for (int64_t a = lo; a < hi; ++a) {
          int32_t il = fst_.ilabels[a];
          if (il == 0) continue;
          float ac = -acoustic_scale * frame[tid2pdf[il - 1]];
          float nc = tok.cost + fst_.weights[a] + ac;
          if (nc >= next_best + beam) continue;
          if (nc < next_best) next_best = nc;
          Relax(next_, fst_.nextstates[a], nc, tok.bp, il, fst_.olabels[a]);
        }
      }
      cur_.swap(next_);
      if (cur_.empty()) return TFKS_ERR_EMPTY;  // beam collapsed
      ProcessNonemitting(beam);
    }

    // Pick the best token, preferring ones in final states.
    const Token *best = nullptr;
    bool partial = true;
    float best_cost = kInf;
    for (const Token &tok : cur_) {
      float fw = fst_.final_w[tok.state];
      if (fw != kInf && tok.cost + fw < best_cost) {
        best_cost = tok.cost + fw;
        best = &tok;
        partial = false;
      }
    }
    if (!best) {
      for (const Token &tok : cur_) {
        if (tok.cost < best_cost) {
          best_cost = tok.cost;
          best = &tok;
        }
      }
    }
    if (!best) return TFKS_ERR_EMPTY;
    *total_cost = best_cost;
    words->clear();
    alignment->clear();
    for (int32_t bp = best->bp; bp >= 0; bp = arena_[bp].prev) {
      if (arena_[bp].olabel > 0) words->push_back(arena_[bp].olabel);
      if (arena_[bp].ilabel > 0) alignment->push_back(arena_[bp].ilabel);
    }
    std::reverse(words->begin(), words->end());
    std::reverse(alignment->begin(), alignment->end());
    return partial ? 1 : 0;
  }

 private:
  // Insert-or-improve a token for `state` in `toks`. The backpointer
  // arena entry is only allocated when the candidate is accepted —
  // rejected expansions must not grow the (per-utterance) arena.
  bool Relax(std::vector<Token> &toks, int32_t state, float cost,
             int32_t prev_bp, int32_t ilabel, int32_t olabel) {
    int32_t idx = tok_idx_[state];
    if (idx < 0 || idx >= static_cast<int32_t>(toks.size()) ||
        toks[idx].state != state) {
      tok_idx_[state] = static_cast<int32_t>(toks.size());
      touched_.push_back(state);
      arena_.push_back({prev_bp, ilabel, olabel});
      toks.push_back({state, cost,
                      static_cast<int32_t>(arena_.size()) - 1});
      return true;
    }
    if (cost < toks[idx].cost) {
      toks[idx].cost = cost;
      arena_.push_back({prev_bp, ilabel, olabel});
      toks[idx].bp = static_cast<int32_t>(arena_.size()) - 1;
      return true;
    }
    return false;
  }

  // Expand epsilon (ilabel==0) arcs until closure, beam-pruned around the
  // in-frame best. Re-queues states whose cost improves; zero-cost epsilon
  // cycles terminate because re-queue requires strict improvement.
  void ProcessNonemitting(float beam) {
    float best = kInf;
    for (const Token &t : cur_) best = std::min(best, t.cost);
    float cutoff = best + beam;
    queue_.clear();
    for (size_t i = 0; i < cur_.size(); ++i)
      queue_.push_back(static_cast<int32_t>(i));
    while (!queue_.empty()) {
      int32_t ti = queue_.back();
      queue_.pop_back();
      Token tok = cur_[ti];  // copy: cur_ may reallocate below
      if (tok.cost > cutoff) continue;
      int64_t lo = fst_.offsets[tok.state], hi = fst_.offsets[tok.state + 1];
      for (int64_t a = lo; a < hi; ++a) {
        if (fst_.ilabels[a] != 0) continue;
        float nc = tok.cost + fst_.weights[a];
        if (nc > cutoff) continue;
        if (Relax(cur_, fst_.nextstates[a], nc, tok.bp, 0,
                  fst_.olabels[a])) {
          queue_.push_back(tok_idx_[fst_.nextstates[a]]);
          if (nc < best) {
            best = nc;
            cutoff = best + beam;
          }
        }
      }
    }
  }

  // Beam cutoff, tightened so at most max_active tokens survive.
  float GetCutoff(float beam, int32_t max_active) {
    float best = kInf;
    for (const Token &t : cur_) best = std::min(best, t.cost);
    float cutoff = best + beam;
    if (max_active > 0 && static_cast<int32_t>(cur_.size()) > max_active) {
      costs_.clear();
      for (const Token &t : cur_) costs_.push_back(t.cost);
      std::nth_element(costs_.begin(), costs_.begin() + max_active - 1,
                       costs_.end());
      cutoff = std::min(cutoff, costs_[max_active - 1]);
    }
    return cutoff;
  }

  const Fst &fst_;
  std::vector<int32_t> tok_idx_;   // state -> index in the "owning" vector
  std::vector<int32_t> touched_;   // states with a live tok_idx_ entry
  std::vector<Token> cur_, next_;
  std::vector<int32_t> queue_;
  std::vector<BackPtr> arena_;
  std::vector<float> costs_;

  // ------------------------------------------------------------------
  // Lattice generation (latgen-faster-mapped semantics): token passing
  // where every surviving arc expansion is kept as a lattice link, then
  // the token DAG is pruned to paths within lattice_beam of the best.
  // Mirrors decode_lattice_py in backend/decoder.py (the test oracle).

  struct Link {
    int32_t src, il, ol;
    float gc, ac;  // graph cost, UNSCALED acoustic cost
  };

 public:
  int DecodeLattice(const float *loglikes, int32_t num_frames,
                    int32_t num_pdfs, const int32_t *tid2pdf,
                    int32_t num_tids, float acoustic_scale, float beam,
                    float lattice_beam, int32_t max_active,
                    std::vector<int32_t> *arc_fields,  // src,dst,il,ol x N
                    std::vector<float> *arc_costs,     // gc,ac x N
                    std::vector<int32_t> *final_states,
                    std::vector<float> *final_costs, int32_t *num_states_out,
                    int32_t *start_out) {
    if (fst_.start < 0) return TFKS_ERR_EMPTY;
    lt_cost_.clear();
    lt_links_.clear();
    lt_expanded_.clear();
    for (int32_t s : touched_) tok_idx_[s] = -1;
    touched_.clear();
    // cur frame: tok_idx_[state] -> global token id; lt_states_ lists the
    // frame's (state, tok) pairs for iteration.
    lt_states_.clear();
    int32_t start_tok = NewTok(0, 0.0f);
    tok_idx_[fst_.start] = start_tok;
    touched_.push_back(static_cast<int32_t>(fst_.start));
    lt_states_.push_back({static_cast<int32_t>(fst_.start), start_tok});
    LatticeEpsClosure(0, beam);

    for (int32_t t = 0; t < num_frames; ++t) {
      const float *frame = loglikes + static_cast<int64_t>(t) * num_pdfs;
      float best = kInf;
      for (auto &st : lt_states_) best = std::min(best, lt_cost_[st.tok]);
      float cutoff = best + beam;
      if (max_active > 0 &&
          static_cast<int32_t>(lt_states_.size()) > max_active) {
        costs_.clear();
        for (auto &st : lt_states_) costs_.push_back(lt_cost_[st.tok]);
        std::nth_element(costs_.begin(), costs_.begin() + max_active - 1,
                         costs_.end());
        cutoff = std::min(cutoff, costs_[max_active - 1]);
      }
      std::vector<StateTok> prev;
      prev.swap(lt_states_);
      for (int32_t s : touched_) tok_idx_[s] = -1;
      touched_.clear();
      float next_best = kInf;
      for (auto &st : prev) {
        float cost = lt_cost_[st.tok];
        if (cost > cutoff) continue;
        int64_t lo = fst_.offsets[st.state], hi = fst_.offsets[st.state + 1];
        for (int64_t a = lo; a < hi; ++a) {
          int32_t il = fst_.ilabels[a];
          if (il == 0) continue;
          float gc = fst_.weights[a];
          float raw_ac = -frame[tid2pdf[il - 1]];
          float nc = cost + gc + acoustic_scale * raw_ac;
          if (nc >= next_best + beam) continue;
          if (nc < next_best) next_best = nc;
          int32_t ns = fst_.nextstates[a];
          int32_t dst = tok_idx_[ns];
          if (dst < 0) {
            dst = NewTok(t + 1, nc);
            tok_idx_[ns] = dst;
            touched_.push_back(ns);
            lt_states_.push_back({ns, dst});
          } else if (nc < lt_cost_[dst]) {
            lt_cost_[dst] = nc;
          }
          AddLink(dst, {st.tok, il, fst_.olabels[a], gc, raw_ac});
        }
      }
      if (lt_states_.empty()) return TFKS_ERR_EMPTY;
      LatticeEpsClosure(t + 1, beam);
    }

    // Final tokens (partial fallback: every last-frame token, cost 0).
    std::vector<std::pair<int32_t, float>> finals;
    for (auto &st : lt_states_) {
      float fw = fst_.final_w[st.state];
      if (fw != kInf) finals.push_back({st.tok, fw});
    }
    bool partial = finals.empty();
    if (partial)
      for (auto &st : lt_states_) finals.push_back({st.tok, 0.0f});

    // Backward pass over the token DAG; token ids are topological except
    // in-frame eps improvement loops, so iterate to a fixed point.
    size_t n = lt_cost_.size();
    std::vector<float> beta(n, kInf);
    for (auto &f : finals) beta[f.first] = std::min(beta[f.first], f.second);
    bool changed = true;
    while (changed) {
      changed = false;
      for (int64_t dst = n - 1; dst >= 0; --dst) {
        float bd = beta[dst];
        if (bd == kInf) continue;
        for (const Link &l : lt_links_[dst]) {
          float cand = bd + l.gc + acoustic_scale * l.ac;
          if (cand < beta[l.src] - 1e-12f) {
            beta[l.src] = cand;
            changed = true;
          }
        }
      }
    }
    float best_total = kInf;
    for (auto &f : finals)
      best_total = std::min(best_total, lt_cost_[f.first] + f.second);

    std::vector<int32_t> renum(n, -1);
    int32_t kept = 0;
    for (size_t i = 0; i < n; ++i) {
      if (beta[i] != kInf &&
          lt_cost_[i] + beta[i] - best_total <= lattice_beam)
        renum[i] = kept++;
    }
    if (renum[start_tok] < 0) return TFKS_ERR_EMPTY;
    arc_fields->clear();
    arc_costs->clear();
    final_states->clear();
    final_costs->clear();
    for (size_t dst = 0; dst < n; ++dst) {
      if (renum[dst] < 0) continue;
      for (const Link &l : lt_links_[dst]) {
        if (renum[l.src] < 0) continue;
        if (lt_cost_[l.src] + l.gc + acoustic_scale * l.ac + beta[dst] -
                best_total >
            lattice_beam + 1e-9f)
          continue;
        arc_fields->push_back(renum[l.src]);
        arc_fields->push_back(renum[dst]);
        arc_fields->push_back(l.il);
        arc_fields->push_back(l.ol);
        arc_costs->push_back(l.gc);
        arc_costs->push_back(l.ac);
      }
    }
    for (auto &f : finals) {
      if (renum[f.first] >= 0) {
        final_states->push_back(renum[f.first]);
        final_costs->push_back(f.second);
      }
    }
    *num_states_out = kept;
    *start_out = renum[start_tok];
    return partial ? 1 : 0;
  }

 private:
  struct StateTok {
    int32_t state, tok;
  };

  int32_t NewTok(int32_t, float cost) {
    lt_cost_.push_back(cost);
    lt_links_.emplace_back();
    lt_expanded_.push_back(0);
    return static_cast<int32_t>(lt_cost_.size()) - 1;
  }

  void AddLink(int32_t dst, Link l) { lt_links_[dst].push_back(l); }

  void LatticeEpsClosure(int32_t frame, float beam) {
    float best = kInf;
    for (auto &st : lt_states_) best = std::min(best, lt_cost_[st.tok]);
    float cutoff = best + beam;
    lt_queue_.clear();
    for (auto &st : lt_states_) lt_queue_.push_back(st);
    while (!lt_queue_.empty()) {
      StateTok st = lt_queue_.back();
      lt_queue_.pop_back();
      float cost = lt_cost_[st.tok];
      if (cost > cutoff) continue;
      // Links carry arc costs only (independent of the source's cost), so
      // each (source, arc) pair is linked at most once per EXISTING
      // destination — on the source's FIRST expansion, if it passes the
      // then-current cutoff. Re-pops after a cost improvement propagate the
      // better cost downstream but add no links — EXCEPT when the re-pop
      // creates a brand-new token, which must be linked or it survives
      // pruning with no incoming arc (identical rule in the Python oracle).
      bool first = !lt_expanded_[st.tok];
      lt_expanded_[st.tok] = 1;
      int64_t lo = fst_.offsets[st.state], hi = fst_.offsets[st.state + 1];
      for (int64_t a = lo; a < hi; ++a) {
        if (fst_.ilabels[a] != 0) continue;
        float gc = fst_.weights[a];
        float nc = cost + gc;
        if (nc > cutoff) continue;
        int32_t ns = fst_.nextstates[a];
        int32_t dst = tok_idx_[ns];
        bool created = dst < 0;
        if (created) {
          dst = NewTok(frame, nc);
          tok_idx_[ns] = dst;
          touched_.push_back(ns);
          lt_states_.push_back({ns, dst});
          lt_queue_.push_back({ns, dst});
        } else if (nc < lt_cost_[dst]) {
          lt_cost_[dst] = nc;
          lt_queue_.push_back({ns, dst});
        }
        if (first || created) AddLink(dst, {st.tok, 0, fst_.olabels[a], gc, 0.0f});
        if (nc < best) {
          best = nc;
          cutoff = best + beam;
        }
      }
    }
  }

  std::vector<float> lt_cost_;
  std::vector<std::vector<Link>> lt_links_;
  std::vector<char> lt_expanded_;
  std::vector<StateTok> lt_states_, lt_queue_;
};

}  // namespace

extern "C" {

void *tfks_fst_load(const char *path) { return load_fst(path); }

void tfks_fst_free(void *h) { delete static_cast<Fst *>(h); }

int64_t tfks_fst_states(void *h) {
  return static_cast<int64_t>(static_cast<Fst *>(h)->final_w.size());
}

int64_t tfks_fst_arcs(void *h) {
  return static_cast<int64_t>(static_cast<Fst *>(h)->ilabels.size());
}

int64_t tfks_fst_start(void *h) { return static_cast<Fst *>(h)->start; }

int tfks_fst_validate(void *h, const int32_t *tid2pdf, int32_t num_tids,
                      int32_t num_pdfs) {
  Fst *fst = static_cast<Fst *>(h);
  if (!fst) return TFKS_ERR_IO;
  for (int32_t il : fst->ilabels) {
    if (il < 0 || il > num_tids ||
        (il > 0 && (tid2pdf[il - 1] < 0 || tid2pdf[il - 1] >= num_pdfs)))
      return TFKS_ERR_LABEL;
  }
  return 0;
}

void *tfks_decoder_new(void *fst_handle) {
  Fst *fst = static_cast<Fst *>(fst_handle);
  if (!fst) return nullptr;
  return new Decoder(*fst);
}

void tfks_decoder_free(void *ctx) { delete static_cast<Decoder *>(ctx); }

int tfks_decode_lattice(void *ctx, const float *loglikes, int32_t num_frames,
                        int32_t num_pdfs, const int32_t *tid2pdf,
                        int32_t num_tids, float acoustic_scale, float beam,
                        float lattice_beam, int32_t max_active,
                        int32_t *out_arcs, float *out_arc_costs,
                        int32_t cap_arcs, int32_t *out_finals,
                        float *out_final_costs, int32_t cap_finals,
                        int32_t *out_narcs, int32_t *out_nfinals,
                        int32_t *out_nstates, int32_t *out_start) {
  Decoder *dec = static_cast<Decoder *>(ctx);
  if (!dec) return TFKS_ERR_IO;
  std::vector<int32_t> arc_fields, final_states;
  std::vector<float> arc_costs, final_costs;
  int32_t num_states = 0, start = 0;
  int rc = dec->DecodeLattice(loglikes, num_frames, num_pdfs, tid2pdf,
                              num_tids, acoustic_scale, beam, lattice_beam,
                              max_active, &arc_fields, &arc_costs,
                              &final_states, &final_costs, &num_states,
                              &start);
  if (rc < 0) return rc;
  int32_t narcs = static_cast<int32_t>(arc_fields.size() / 4);
  int32_t nfinals = static_cast<int32_t>(final_states.size());
  if (narcs > cap_arcs || nfinals > cap_finals) return TFKS_ERR_CAPACITY;
  std::copy(arc_fields.begin(), arc_fields.end(), out_arcs);
  std::copy(arc_costs.begin(), arc_costs.end(), out_arc_costs);
  std::copy(final_states.begin(), final_states.end(), out_finals);
  std::copy(final_costs.begin(), final_costs.end(), out_final_costs);
  *out_narcs = narcs;
  *out_nfinals = nfinals;
  *out_nstates = num_states;
  *out_start = start;
  return rc;
}

int tfks_decode_faster(void *ctx, const float *loglikes, int32_t num_frames,
                       int32_t num_pdfs, const int32_t *tid2pdf,
                       int32_t num_tids, float acoustic_scale, float beam,
                       int32_t max_active, int32_t *out_words,
                       int32_t cap_words, int32_t *out_align,
                       int32_t cap_align, int32_t *out_nwords,
                       int32_t *out_nalign, float *out_cost) {
  Decoder *dec = static_cast<Decoder *>(ctx);
  if (!dec) return TFKS_ERR_IO;
  std::vector<int32_t> words, alignment;
  float cost = 0.0f;
  int rc = dec->Decode(loglikes, num_frames, num_pdfs, tid2pdf, num_tids,
                       acoustic_scale, beam, max_active, &words, &alignment,
                       &cost);
  if (rc < 0) return rc;
  if (static_cast<int32_t>(words.size()) > cap_words ||
      static_cast<int32_t>(alignment.size()) > cap_align)
    return TFKS_ERR_CAPACITY;
  std::copy(words.begin(), words.end(), out_words);
  std::copy(alignment.begin(), alignment.end(), out_align);
  *out_nwords = static_cast<int32_t>(words.size());
  *out_nalign = static_cast<int32_t>(alignment.size());
  *out_cost = cost;
  return rc;
}

}  // extern "C"
