// The systems step: one launch runs the whole Step graph minus the sensor
// pass, for every world, in place on the world state.
//
// Replaces madrona_bots_tpu/ops/step_pallas.py::fused_step_systems: its
// Pallas kernel `_kernel` (:146) and the XLA code around it (food spawn,
// action system, finder-dependent step-start quantities, respawn draws,
// the post-pass). Plain version: ops/step_cuda.py::step_systems_plain, the
// composition prepass + systems_reference + post-pass.
//
// Design: one thread block per world, one thread per agent slot
// (blockDim = A rounded up to a warp). The world's food packages, random
// draws, step-start alive/species copy, shot histogram, chunk tallies,
// claim tables and scan buffer sit in shared memory (about 7.5 KB at
// A = 128, C = 48, P = 5). The phases, each ending in __syncthreads():
//   0. load the food into shared memory; derive the world's step key
//      fold_in(world_key, t) and draw, one value a thread, the food-spawn
//      integers (gate, attempts, two chunk/cell 4-vectors: jax's randint)
//      and the respawn positions (jax's uniform) with uint32 threefry2x32;
//   1. thread 0 places food (the first empty package of the drawn chunk,
//      attempt 1 after attempt 0); every slot runs the action system:
//      crosshair target from the shared alive/species copy, shots as a
//      shared atomicAdd histogram, rotate, glibc sincos, move and clamp,
//      quantised speed, chunk and cell, breed eligibility;
//   2. the chain: damage; eat (packages in order, the lowest contender of
//      a chunk wins: shared atomicMin, deterministic); breed, death; chunk
//      tallies; class-partitioned birth claims (per-class scans); the
//      bilinear `surrounding` at post-birth positions; species counts and
//      health sums; respawn top-up from the free slots left in each class;
//   3. post-pass: health, species, heading, position, stats, rewards (all
//      eight settings) and the dead-slot canonicalisation, written in place;
//      then the block copies or fills the prev sensor rows and clears the
//      rows of dead and fresh slots with 16-byte accesses where the rows
//      allow, and writes the food tables, counts and species rewards.
// Every read of a world's step-start values happens before the barrier
// that precedes the first write to that world; a world belongs to one
// block. The new step count goes to a second buffer (every block reads t).
//
// Arithmetic: built with -fmad=false; every f32 op is its own __f*_rn, and
// __fmaf_rn stands exactly where the plain version calls trig.fma_f32, so
// every field but `surrounding` is bit-exact against the plain version and
// `surrounding` follows its operation order.
//
// Bound: bytes. At W = 8192, A = 128 the step reads and writes roughly
// 100 B a slot (positions, headings, health, actions, the 2 x 32 sensor
// bytes copied to the prev rows, the new fields) plus 2.9 KB of food a
// world: ~0.1 GB, ~30 us at 3.35 TB/s. The threefry draws are ~100 calls a
// world of 20 integer rounds, spread over the block's threads.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "scan.cuh"
#include "trig.cuh"

namespace {

constexpr uint32_t kSaltFood = 1, kSaltRespawn = 2;
constexpr int kFoodDraws = 10;  // gate, attempts, 2 x (chunk x, chunk y, cell x, cell y)

// The world state's fields in `WorldState` order, then the new step count.
struct Ptrs {
  float* pos;
  float* heading;
  int* health;
  uint8_t* alive;
  int* species;
  int* stats;
  float* hidden;
  int* action;
  float* surrounding;
  float* reward;
  const uint8_t* sensor_depth;
  const int8_t* sensor_semantic;
  uint8_t* prev_sensor_depth;
  int8_t* prev_sensor_semantic;
  const int* finder;
  int* prev_species;
  float* prev_pos;
  int* prev_health;
  float* prev_surrounding;
  float* prev_reward;
  int* prev_action;
  int* prev_stats;
  float* prev_hidden;
  int* food_count;
  int* food_cell;
  int* num_food;
  int* species_counts;
  float* species_rewards;
  const int* step_count;
  const int64_t* world_keys;
  int* step_count_out;
};
constexpr int kNumPtrs = 31;
static_assert(sizeof(Ptrs) == kNumPtrs * sizeof(void*), "Ptrs holds pointers only");

// ops/step_cuda.py::_Params has the same fields in the same order.
struct Params {
  int A, H, S, ncx, ncy, cw, P, NS, FL;
  int total_food, shoot_damage, eat_health, breed_min_health, breed_cost;
  int child_health, init_health, reward_setting, d1, d3;
  float cell_dim, rotation_delta, move_speed, lim_x, lim_y, clamp_x, clamp_y;
  float edge_x, edge_y, recip_init, recip100;
};

// ---- counter RNG: jax's threefry2x32, 20 rounds, in uint32 ----

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

__device__ __forceinline__ Key threefry(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i & 1) {
      mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
    } else {
      mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return {x0, x1};
}

__device__ __forceinline__ Key fold_in(Key k, uint32_t d) { return threefry(k, 0u, d); }

// Word `ctr` of jax's random_bits(key, shape), row-major flat index.
__device__ __forceinline__ uint32_t random_word(Key k, uint32_t ctr) {
  const Key y = threefry(k, 0u, ctr);
  return y.k0 ^ y.k1;
}

// Element `ctr` of jax's randint(key, shape, lo, lo + span): two words from
// the keys (0, 0) and (0, 1), folded into the span in wrapping uint32.
__device__ __forceinline__ int randint(Key k, uint32_t ctr, int lo, uint32_t span) {
  const uint32_t higher = random_word(threefry(k, 0u, 0u), ctr);
  const uint32_t lower = random_word(threefry(k, 0u, 1u), ctr);
  const uint32_t m = 65536u % span;
  const uint32_t mult = (m * m) % span;
  const uint32_t offset = (higher % span) * mult + lower % span;
  return lo + (int)(offset % span);
}

// ---- the post-pass's float forms (XLA's jitted rewrites) ----

// count / init_agents + mean health / 100 - 2, as fma(cf, 1/init,
// avg * 0.01) - 2 with avg a true division.
__device__ __forceinline__ float species_reward(int count, int hsum, const Params& p) {
  const float cf = (float)count;
  const float avg = count > 0 ? __fdiv_rn((float)hsum, cf) : 0.f;
  return __fsub_rn(__fmaf_rn(cf, p.recip_init, __fmul_rn(avg, p.recip100)), 2.f);
}

__device__ __forceinline__ float bonus(bool flag, float v) { return flag ? v : 0.f; }

// reward_system for one slot (before the alive mask).
__device__ __forceinline__ float slot_reward(float base, int health, float x, float y,
                                             bool hf, bool he, bool ate, bool repro,
                                             const Params& p) {
  const float pop = __fsub_rn(__fmaf_rn((float)health, p.recip100, base), 0.5f);
  switch (p.reward_setting) {
    case 2: {
      const bool edge = x < 4.f || y < 4.f || x > p.edge_x || y > p.edge_y;
      float r = __fsub_rn(pop, bonus(edge, 1.f));
      r = __fsub_rn(__fadd_rn(r, bonus(repro, 10.f)), bonus(hf, 5.f));
      return __fadd_rn(__fadd_rn(r, bonus(he, 15.f)), bonus(ate, 7.f));
    }
    case 3:
      return __fadd_rn(__fadd_rn(bonus(repro, 10.f), bonus(he, 15.f)), bonus(ate, 7.f));
    case 4:
      return __fadd_rn(__fsub_rn(__fadd_rn(bonus(repro, 10.f), bonus(he, 15.f)),
                                 bonus(hf, 5.f)),
                       bonus(ate, 7.f));
    case 5:
      return pop;
    case 6:
      return __fadd_rn(pop, bonus(ate, 10.f));
    case 7:
      return __fadd_rn(__fadd_rn(pop, bonus(ate, 10.f)), bonus(repro, 10.f));
    case 9:  // SETTING_7B
      return __fadd_rn(__fadd_rn(__fsub_rn(__fadd_rn(pop, bonus(repro, 10.f)),
                                           bonus(hf, 5.f)),
                                 bonus(he, 15.f)),
                       bonus(ate, 7.f));
    default:  // SETTING_8
      return __fadd_rn(__fadd_rn(__fadd_rn(pop, bonus(ate, 10.f)), bonus(repro, 10.f)),
                       bonus(he, 15.f));
  }
}

// ---- per-slot rows of the world ----

// Row `row` of a [.., 2] f32 / [.., 4] i32 field: one vector store where
// the pointer allows it (a contiguous view may start off alignment).
__device__ __forceinline__ void store2(float* f, size_t row, float x, float y) {
  if (((uintptr_t)f & 7) == 0) {
    ((float2*)f)[row] = make_float2(x, y);
  } else {
    f[2 * row] = x;
    f[2 * row + 1] = y;
  }
}

__device__ __forceinline__ void store4(int* f, size_t row, int x, int y, int z, int u) {
  if (((uintptr_t)f & 15) == 0) {
    ((int4*)f)[row] = make_int4(x, y, z, u);
  } else {
    f[4 * row] = x;
    f[4 * row + 1] = y;
    f[4 * row + 2] = z;
    f[4 * row + 3] = u;
  }
}

// The rows below are written by the whole block.

constexpr int kClear = 1, kKeep = 2;  // per-slot flags in shared memory

// dst row of each slot = src row where the slot's flags hold kKeep, else
// the byte pattern `fill` (a 4-byte word of it). Rows are `rb` bytes,
// rb % 4 == 0; 16-byte accesses when rows and pointers allow.
__device__ __forceinline__ void copy_or_fill(uint8_t* dst, const uint8_t* src, int rb,
                                             uint32_t fill, const int* flags, int A) {
  if (rb % 16 == 0 && (((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const int per = rb / 16;
    const uint4 f4 = make_uint4(fill, fill, fill, fill);
    for (int i = threadIdx.x; i < A * per; i += blockDim.x)
      ((uint4*)dst)[i] = (flags[i / per] & kKeep) ? ((const uint4*)src)[i] : f4;
  } else {
    const int per = rb / 4;
    for (int i = threadIdx.x; i < A * per; i += blockDim.x)
      ((uint32_t*)dst)[i] = (flags[i / per] & kKeep) ? ((const uint32_t*)src)[i] : fill;
  }
}

// Zero the rows of the slots whose flags hold kClear; the others stay.
__device__ __forceinline__ void clear_rows(void* dst_, int rb, const int* flags, int A) {
  uint8_t* dst = (uint8_t*)dst_;
  if (rb % 16 == 0 && ((uintptr_t)dst & 15) == 0) {
    const int per = rb / 16;
    for (int i = threadIdx.x; i < A * per; i += blockDim.x)
      if (flags[i / per] & kClear) ((uint4*)dst)[i] = make_uint4(0, 0, 0, 0);
  } else {
    const int per = rb / 4;
    for (int i = threadIdx.x; i < A * per; i += blockDim.x)
      if (flags[i / per] & kClear) ((uint32_t*)dst)[i] = 0u;
  }
}

__global__ void step_systems_kernel(Ptrs g, Params p) {
  const int A = p.A, NS = p.NS, P = p.P, FL = p.FL, cw = p.cw;
  const int C = p.ncx * p.ncy, CP = C * P;
  const int w = blockIdx.x, a = threadIdx.x, nt = blockDim.x;
  const bool valid = a < A;
  const size_t row = (size_t)w * A + a;
  const float cwf = (float)cw;

  extern __shared__ int smem[];
  int* f_cnt = smem;               // [C * P] package count (after the spawn)
  int* f_cell = f_cnt + CP;        // [C * P] package cell id, x + cw * y
  int* cons = f_cell + CP;         // [C * P] consumed this step
  int* winner = cons + CP;         // [C] lowest contender slot
  int* tal_n = winner + C;         // [C] alive agents per chunk
  int* tal_s = tal_n + C;          // [C] summed quantised speed per chunk
  int* scan = tal_s + C;           // [A]
  int* sh_alive = scan + A;        // [A] step-start alive
  int* sh_species = sh_alive + A;  // [A] step-start species
  int* shots = sh_species + A;     // [A] valid shots landing on each slot
  int* flags = shots + A;          // [A] kClear | kKeep
  float* ptab_x = (float*)(flags + A);  // [NS][A / NS] parent position by rank
  float* ptab_y = ptab_x + A;
  float* drawx = ptab_y + A;            // [NS * FL] respawn draws
  float* drawy = drawx + NS * FL;
  int* cls_tot = (int*)(drawy + NS * FL);  // [2 * NS] free / breeder totals
  int* cnt = cls_tot + 2 * NS;             // [NS]
  int* hs = cnt + NS;                      // [NS]
  int* fv = hs + NS;                       // [kFoodDraws] food-spawn integers
  int* misc = fv + kFoodDraws;             // [0] food after spawn, [1] consumed

  // ---- 0. loads, the world's keys, the random draws ----
  const int* fcnt_g = g.food_count + (size_t)w * CP;
  int* fcell_g = g.food_cell + (size_t)w * CP * 2;
  for (int i = a; i < CP; i += nt) {
    f_cnt[i] = fcnt_g[i];
    f_cell[i] = fcell_g[2 * i] + cw * fcell_g[2 * i + 1];
    cons[i] = 0;
  }
  for (int i = a; i < C; i += nt) {
    tal_n[i] = 0;
    tal_s[i] = 0;
  }
  for (int i = a; i < NS; i += nt) {
    cnt[i] = 0;
    hs[i] = 0;
  }
  if (a == 0) misc[1] = 0;
  const bool alive0 = valid && g.alive[row] != 0;
  const int species = valid ? g.species[row] : 0;
  if (valid) {
    sh_alive[a] = alive0;
    sh_species[a] = species;
    shots[a] = 0;
  }

  const uint32_t t = (uint32_t)*g.step_count;
  const Key kt = fold_in({(uint32_t)g.world_keys[2 * w], (uint32_t)g.world_keys[2 * w + 1]}, t);
  for (int i = a; i < kFoodDraws + 2 * NS * FL; i += nt) {
    if (i < kFoodDraws) {
      // gate = randint(fold_in(k, 0), 0, 10); n = randint(fold_in(k, 1), 1, 3);
      // randint(fold_in(k, 2 + j), (4,), 0, [ncx, ncy, cw, cw]).
      const Key kf = fold_in(kt, kSaltFood);
      int lo = 0, hi;
      uint32_t j, comp = 0;
      if (i < 2) {
        j = i;
        lo = i;
        hi = i == 0 ? 10 : 3;
      } else {
        j = 2 + (i - 2) / 4;
        comp = (i - 2) % 4;
        hi = comp == 0 ? p.ncx : comp == 1 ? p.ncy : cw;
      }
      const uint32_t span = hi <= lo ? 1u : (uint32_t)(hi - lo);
      fv[i] = randint(fold_in(kf, j), comp, lo, span);
    } else {
      // uniform(fold_in(k_respawn, s), (FL, 2)) * [lim_x, lim_y]
      const int q = i - kFoodDraws, s = q / (2 * FL), rest = q % (2 * FL);
      const uint32_t bits = random_word(fold_in(fold_in(kt, kSaltRespawn), s), rest);
      const float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.f);
      if (rest & 1)
        drawy[s * FL + rest / 2] = __fmul_rn(u, p.lim_y);
      else
        drawx[s * FL + rest / 2] = __fmul_rn(u, p.lim_x);
    }
  }
  __syncthreads();

  // ---- 1a. food spawn: up to two placements, in order ----
  if (a == 0) {
    int nf = g.num_food[w];
    const int n_eff = min(fv[1], max(p.total_food - nf, 0));
    for (int j = 0; j < 2; ++j) {
      const int* v = fv + 2 + 4 * j;
      if (fv[0] != 0 || j >= n_eff) continue;
      const int c = v[0] + v[1] * p.ncx;
      int k = 0;
      while (k < P && f_cnt[c * P + k] > 0) ++k;
      if (k == P) continue;  // every package of the chunk is occupied
      f_cnt[c * P + k] = 1;
      f_cell[c * P + k] = v[2] + cw * v[3];
      fcell_g[2 * (c * P + k)] = v[2];
      fcell_g[2 * (c * P + k) + 1] = v[3];
      ++nf;
    }
    misc[0] = nf;
  }

  // ---- 1b. action system and the step-start quantities ----
  float px = 0.f, py = 0.f, heading = 0.f;
  int finder = -1;
  bool act[6] = {false, false, false, false, false, false};
  if (valid) {
    px = g.pos[2 * row];
    py = g.pos[2 * row + 1];
    heading = g.heading[row];
    finder = g.finder[row];
#pragma unroll
    for (int k = 0; k < 6; ++k) act[k] = g.action[6 * row + k] > 0;
  }
  const bool has = finder >= 0;
  const int tgt = has ? finder : 0;
  const bool ta = has && sh_alive[tgt] != 0;
  const int ts = has ? sh_species[tgt] : 0;
  const bool ta_ok = p.d1 || ta;  // quirk D1: the stale handle skips the alive test
  const bool valid_shot = act[4] && alive0 && has && ta_ok;
  if (valid_shot) atomicAdd(&shots[tgt], 1);
  const bool hit_friendly = valid_shot && ts == species;
  const bool hit_enemy = valid_shot && ts != species;
  const bool breed_ok = act[5] && alive0 && has && ta_ok && ts == species;

  float nh = heading, nx = px, ny = py;
  int speedq = 0, ci = -1;
  if (alive0) {
    const bool rl = act[2], rr = act[3] && !rl;
    nh = __fsub_rn(__fadd_rn(heading, rl ? p.rotation_delta : 0.f),
                   rr ? p.rotation_delta : 0.f);
    const bool fwd = act[0], bwd = act[1] && !fwd;
    // mv * alive is mv here (alive = 1).
    const float mv = __fsub_rn(fwd ? p.move_speed : 0.f, bwd ? p.move_speed : 0.f);
    float cs, sn;
    mbots::sincosf_glibc(nh, &cs, &sn);
    nx = __fadd_rn(px, __fmul_rn(cs, mv));
    ny = __fadd_rn(py, __fmul_rn(sn, mv));
    nx = nx < 0.f ? 0.f : nx;
    ny = ny < 0.f ? 0.f : ny;
    nx = nx > p.clamp_x ? p.clamp_x : nx;
    ny = ny > p.clamp_y ? p.clamp_y : ny;
    const float dx = __fsub_rn(nx, px), dy = __fsub_rn(ny, py);
    speedq = __float2int_rz(
        __fmul_rn(__fsqrt_rn(__fmaf_rn(dy, dy, __fmul_rn(dx, dx))), 2.f));
    const float chx = __fdiv_rn(__fdiv_rn(nx, p.cell_dim), cwf);
    const float chy = __fdiv_rn(__fdiv_rn(ny, p.cell_dim), cwf);
    const int cx = min(max(__float2int_rz(floorf(chx)), 0), p.ncx - 1);
    const int cy = min(max(__float2int_rz(floorf(chy)), 0), p.ncy - 1);
    ci = cx + cy * p.ncx;
  }
  // Cell within the chunk: cw * frac(pos / cell_dim / cw), truncated.
  const float chx = __fdiv_rn(__fdiv_rn(nx, p.cell_dim), cwf);
  const float chy = __fdiv_rn(__fdiv_rn(ny, p.cell_dim), cwf);
  const int cell = __float2int_rz(__fmul_rn(cwf, __fsub_rn(chx, floorf(chx)))) +
                   cw * __float2int_rz(__fmul_rn(cwf, __fsub_rn(chy, floorf(chy))));
  __syncthreads();  // the placements and the shot histogram are complete

  // ---- 2. the chain ----
  const int cls = a % NS;
  const int health0 = valid ? g.health[row] : 0;
  int health = alive0 ? health0 - p.shoot_damage * shots[a] : health0;

  // eat
  bool eaten = false;
  int consumed = 0;
  for (int pk = 0; pk < P; ++pk) {
    for (int i = a; i < C; i += nt) winner[i] = A;
    __syncthreads();
    const bool contend = alive0 && ci >= 0 && !eaten && f_cnt[ci * P + pk] > 0 &&
                         cell == f_cell[ci * P + pk];
    if (contend) atomicMin(&winner[ci], a);
    __syncthreads();
    if (contend && winner[ci] == a) eaten = true;
    for (int i = a; i < C; i += nt)
      if (winner[i] < A) {
        cons[i * P + pk] = 1;
        ++consumed;
      }
    __syncthreads();
  }
  if (consumed) atomicAdd(&misc[1], consumed);
  health += p.eat_health * (int)eaten;

  // breed, death
  const bool breeder = breed_ok && health > p.breed_min_health;
  health -= p.breed_cost * (int)breeder;
  const bool alive_ad = alive0 && health > 0;

  // chunk tallies at the post-move position, step-start liveness
  if (alive0 && ci >= 0) {
    atomicAdd(&tal_n[ci], 1);
    atomicAdd(&tal_s[ci], speedq);
  }

  // birth claims within the slot class
  const bool free0 = valid && !alive0;
  const int free_incl = mbots::strided_scan(free0, scan, a, valid, A, NS);
  if (valid && a >= A - NS) cls_tot[cls] = free_incl;
  const int want_incl = mbots::strided_scan(breeder, scan, a, valid, A, NS);
  if (valid && a >= A - NS) cls_tot[NS + cls] = want_incl;
  __syncthreads();
  const int asub = A / NS;
  const int num_free = cls_tot[cls];
  const int free_rank = free_incl - 1;
  const int want_rank = want_incl - 1;
  const int grant_cnt = min(cls_tot[NS + cls], num_free);
  if (breeder && want_rank < num_free) {
    ptab_x[cls * asub + want_rank] = nx;
    ptab_y[cls * asub + want_rank] = ny;
  }
  __syncthreads();
  const bool born = free0 && free_rank < grant_cnt;
  const float bx = born ? ptab_x[cls * asub + free_rank] : 0.f;
  const float by = born ? ptab_y[cls * asub + free_rank] : 0.f;

  // the bilinear surrounding at the post-birth position
  const bool alive_pb = alive_ad || born;
  float surrp = 0.f, surrm = 0.f;
  if (alive_pb) {
    const float half = cwf * 0.5f;
    const float sx = __fdiv_rn(__fsub_rn(__fdiv_rn(born ? bx : nx, p.cell_dim), half), cwf);
    const float sy = __fdiv_rn(__fsub_rn(__fdiv_rn(born ? by : ny, p.cell_dim), half), cwf);
    const float fx = floorf(sx), fy = floorf(sy), gx = ceilf(sx), gy = ceilf(sy);
    const float xi = __fsub_rn(sx, fx), yi = __fsub_rn(sy, fy);
    const float cxs[4] = {fx, gx, fx, gx}, cys[4] = {fy, fy, gy, gy};
    float vn[4], vs[4];
    for (int k = 0; k < 4; ++k) {
      const int cx = (int)cxs[k], cy = (int)cys[k];
      const bool ok = cx >= 0 && cy >= 0 && cx < p.ncx && cy < p.ncy;
      vn[k] = ok ? (float)tal_n[cx + cy * p.ncx] : 0.f;
      vs[k] = ok ? (float)tal_s[cx + cy * p.ncx] : 0.f;
    }
    const float ox = __fsub_rn(1.f, xi), oy = __fsub_rn(1.f, yi);
    const float n0 = __fadd_rn(__fmul_rn(xi, vn[1]), __fmul_rn(ox, vn[0]));
    const float n1 = __fadd_rn(__fmul_rn(xi, vn[3]), __fmul_rn(ox, vn[2]));
    const float s0 = __fadd_rn(__fmul_rn(xi, vs[1]), __fmul_rn(ox, vs[0]));
    const float s1 = __fadd_rn(__fmul_rn(xi, vs[3]), __fmul_rn(ox, vs[2]));
    surrp = __fadd_rn(__fmul_rn(yi, n1), __fmul_rn(oy, n0));
    surrm = __fadd_rn(__fmul_rn(yi, s1), __fmul_rn(oy, s0));
  }

  // species counts and health sums (post-birth, pre-respawn)
  const int sp_pb = born ? cls + 1 : species;
  if (alive_pb && sp_pb >= 1 && sp_pb <= NS) {
    atomicAdd(&cnt[sp_pb - 1], 1);
    atomicAdd(&hs[sp_pb - 1], born ? p.child_health : health);
  }
  __syncthreads();

  // respawn from the free slots left after births
  const int needed = max(FL - cnt[cls], 0);
  const int free2_rank = free_rank - grant_cnt;
  const bool resp = free0 && !born && free2_rank < needed;

  // ---- 3. post-pass ----
  const bool fresh = born || resp;
  const bool alive1 = alive_ad || fresh;
  const bool dead = !alive1;
  if (valid) {
    int h1 = born ? p.child_health : health;
    h1 = resp ? p.init_health : h1;
    const int sp1 = fresh ? cls + 1 : species;
    float x1 = born ? bx : nx, y1 = born ? by : ny;
    if (resp) {
      x1 = drawx[cls * FL + free2_rank];
      y1 = drawy[cls * FL + free2_rank];
    }
    const bool s_hf = hit_friendly && !fresh, s_he = hit_enemy && !fresh;
    const bool s_ate = eaten && !fresh, s_rep = breeder && !fresh;
    int sp0 = p.d3 ? sp1 : sp1 - 1;  // quirk D3 reads rewards[min(species, NS - 1)]
    sp0 = min(max(sp0, 0), NS - 1);
    const float base = species_reward(cnt[sp0], hs[sp0], p);
    const float r = slot_reward(base, h1, x1, y1, s_hf, s_he, s_ate, s_rep, p);
    const bool keep_surr = alive_pb && !(dead || resp);

    store2(g.pos, row, dead ? 0.f : x1, dead ? 0.f : y1);
    g.heading[row] = (dead || fresh) ? 0.f : nh;
    g.health[row] = dead ? 0 : h1;
    g.alive[row] = alive1;
    g.species[row] = dead ? 0 : sp1;
    if (dead)
      store4(g.stats, row, 0, 0, 0, 0);
    else
      store4(g.stats, row, s_hf, s_he, s_ate, s_rep);
    store2(g.surrounding, row, keep_surr ? surrp : 0.f, keep_surr ? surrm : 0.f);
    g.reward[row] = dead ? 0.f : r;
    if (dead || fresh) {
      g.prev_species[row] = 0;
      g.prev_health[row] = 0;
      g.prev_reward[row] = 0.f;
    }
    flags[a] = ((dead || fresh) ? kClear : 0) | ((alive1 && !fresh) ? kKeep : 0);
  }
  __syncthreads();

  // rows of the whole world, and the world's tables
  const size_t wa = (size_t)w * A;
  copy_or_fill(g.prev_sensor_depth + wa * p.S, g.sensor_depth + wa * p.S, p.S, 0u, flags, A);
  copy_or_fill((uint8_t*)(g.prev_sensor_semantic + wa * p.S),
               (const uint8_t*)(g.sensor_semantic + wa * p.S), p.S, 0xFFFFFFFFu, flags, A);
  clear_rows(g.hidden + wa * p.H, 4 * p.H, flags, A);
  clear_rows(g.action + wa * 6, 24, flags, A);
  clear_rows(g.prev_pos + wa * 2, 8, flags, A);
  clear_rows(g.prev_surrounding + wa * 2, 8, flags, A);
  clear_rows(g.prev_action + wa * 6, 24, flags, A);
  clear_rows(g.prev_stats + wa * 4, 16, flags, A);
  clear_rows(g.prev_hidden + wa * p.H, 4 * p.H, flags, A);
  for (int i = a; i < CP; i += nt) g.food_count[(size_t)w * CP + i] = cons[i] ? 0 : f_cnt[i];
  for (int i = a; i < NS; i += nt) {
    g.species_counts[(size_t)w * NS + i] = cnt[i];
    g.species_rewards[(size_t)w * NS + i] = species_reward(cnt[i], hs[i], p);
  }
  if (a == 0) {
    g.num_food[w] = misc[0] - misc[1];
    if (w == 0) *g.step_count_out = (int)(t + 1u);
  }
}

}  // namespace

// ptrs: the 31 pointers of `Ptrs`; params: a `Params`. Returns
// cudaGetLastError() after the launch.
extern "C" int mbots_step_systems(void* const* ptrs, const void* params, int W,
                                  void* stream) {
  Ptrs g;
  memcpy(&g, ptrs, sizeof(Ptrs));
  Params p;
  memcpy(&p, params, sizeof(Params));
  const int C = p.ncx * p.ncy;
  const int threads = (p.A + 31) / 32 * 32;
  const size_t smem = sizeof(int) * (3 * C * p.P + 3 * C + 7 * p.A + 2 * p.NS * p.FL +
                                     4 * p.NS + kFoodDraws + 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        step_systems_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (W > 0)
    step_systems_kernel<<<W, threads, smem, (cudaStream_t)stream>>>(g, p);
  return (int)cudaGetLastError();
}
