// The systems kernel: one world's step-start-to-respawn chain per block.
//
// Replaces madrona_bots_tpu/ops/step_pallas.py::_kernel (the fused Pallas
// systems megakernel). Plain version: ops/step_cuda.py::systems_reference.
//
// Design: one thread block per world, one thread per agent slot
// (blockDim = A rounded up to a warp). The world's food packages, chunk
// tallies, claim tables and scan buffer sit in shared memory (about 5 KB at
// A = 128, C = 48, P = 5). The stages, each ending in __syncthreads():
//   1. damage (the shot histogram comes from the pre-pass);
//   2. eat: packages in order; the lowest alive slot on a package's cell
//      that has not eaten wins it (shared-memory atomicMin per chunk, which
//      is deterministic), +eat_health;
//   3. breed (breed_ok from the pre-pass and post-eat health), death;
//   4. chunk tallies (alive count, summed quantised speed; integer atomics);
//   5. birth claims: per-class scans rank the free slots and the breeders of
//      each slot class; the r-th granted breeder of class c hands its
//      position to the r-th free slot of class c;
//   6. the bilinear `surrounding` from the 4 corner chunks at post-birth
//      positions, each product and sum its own IEEE f32 op;
//   7. species counts and health sums (post-birth, pre-respawn);
//   8. respawn: the free slots left in class s after births take draws
//      (s, 0), (s, 1), ... up to respawn_floor - count[s].
// Every output but `surrounding` is an integer or a copied float and so is
// exact; `surrounding` uses the plain version's operation order.
//
// Bound: the bytes of [W, A] state in and out (about 60 B per slot plus
// 2 KB of food per world: ~85 MB at W = 8192, A = 128, ~25 us at
// 3.35 TB/s) and launch latency; the arithmetic is a few hundred integer
// ops per slot. The stages are dependent and short, so the block spends
// most of its time in barriers; 8192 blocks of 128 threads keep every SM
// busy with several resident worlds, which hides them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

struct Params {
  int A, ncx, ncy, cw, P, NS, FL;
  int shoot_damage, eat_health, breed_min_health, breed_cost, child_health;
  float cell_dim;
};

__global__ void systems_kernel(
    const uint8_t* __restrict__ alive_in, const int* __restrict__ species_in,
    const int* __restrict__ health_in, const float* __restrict__ posx_in,
    const float* __restrict__ posy_in, const int* __restrict__ speedq_in,
    const int* __restrict__ cidx_in, const int* __restrict__ cell_in,
    const int* __restrict__ food_count, const int* __restrict__ food_cell,
    const float* __restrict__ drawx, const float* __restrict__ drawy,
    const int* __restrict__ dmg_in, const uint8_t* __restrict__ breed_ok_in,
    uint8_t* __restrict__ eaten_out, uint8_t* __restrict__ breeder_out,
    uint8_t* __restrict__ born_out, float* __restrict__ bposx_out,
    float* __restrict__ bposy_out, uint8_t* __restrict__ resp_out,
    float* __restrict__ rposx_out, float* __restrict__ rposy_out,
    float* __restrict__ surrp_out, float* __restrict__ surrm_out,
    int* __restrict__ counts_out, int* __restrict__ hsum_out,
    uint8_t* __restrict__ consumed_out, Params p) {
  const int A = p.A, NS = p.NS, P = p.P, C = p.ncx * p.ncy, CP = C * P;
  const int w = blockIdx.x, a = threadIdx.x, nt = blockDim.x;
  const bool valid = a < A;
  const size_t row = (size_t)w * A + a;

  extern __shared__ int smem[];
  int* f_has = smem;              // [C * P] package present
  int* f_cell = f_has + CP;       // [C * P] package cell id
  int* cons = f_cell + CP;        // [C * P] consumed this step
  int* winner = cons + CP;        // [C] lowest contender slot
  int* tal_n = winner + C;        // [C] alive agents per chunk
  int* tal_s = tal_n + C;         // [C] summed quantised speed per chunk
  int* scan = tal_s + C;          // [A]
  float* ptab_x = (float*)(scan + A);  // [NS][A / NS] parent position by rank
  float* ptab_y = ptab_x + A;
  int* cls_tot = (int*)(ptab_y + A);   // [2 * NS] free / breeder totals
  int* cnt = cls_tot + 2 * NS;         // [NS]
  int* hs = cnt + NS;                  // [NS]

  for (int i = a; i < CP; i += nt) {
    f_has[i] = food_count[(size_t)w * CP + i] > 0;
    f_cell[i] = food_cell[(size_t)w * CP + i];
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

  const bool alive0 = valid && alive_in[row] != 0;
  const int species = valid ? species_in[row] : 0;
  const float px = valid ? posx_in[row] : 0.f;
  const float py = valid ? posy_in[row] : 0.f;
  const int ci = valid ? cidx_in[row] : -1;
  const int cell = valid ? cell_in[row] : -1;
  const int cls = a % NS;

  // 1. damage
  int health = valid ? health_in[row] : 0;
  if (alive0) health -= p.shoot_damage * dmg_in[row];

  // 2. eat
  bool eaten = false;
  for (int pk = 0; pk < P; ++pk) {
    for (int i = a; i < C; i += nt) winner[i] = A;
    __syncthreads();
    const bool contend = alive0 && ci >= 0 && !eaten && f_has[ci * P + pk] &&
                         cell == f_cell[ci * P + pk];
    if (contend) atomicMin(&winner[ci], a);
    __syncthreads();
    if (contend && winner[ci] == a) eaten = true;
    for (int i = a; i < C; i += nt)
      if (winner[i] < A) cons[i * P + pk] = 1;
    __syncthreads();
  }
  health += p.eat_health * (int)eaten;

  // 3. breed, death
  const bool breeder = valid && breed_ok_in[row] != 0 && health > p.breed_min_health;
  health -= p.breed_cost * (int)breeder;
  const bool alive_ad = alive0 && health > 0;

  // 4. chunk tallies at the post-move position, step-start liveness
  if (alive0 && ci >= 0) {
    atomicAdd(&tal_n[ci], 1);
    atomicAdd(&tal_s[ci], speedq_in[row]);
  }

  // 5. birth claims within the slot class
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
    ptab_x[cls * asub + want_rank] = px;
    ptab_y[cls * asub + want_rank] = py;
  }
  __syncthreads();
  const bool born = free0 && free_rank < grant_cnt;
  const float bx = born ? ptab_x[cls * asub + free_rank] : 0.f;
  const float by = born ? ptab_y[cls * asub + free_rank] : 0.f;

  // 6. surrounding at the post-birth position
  const bool alive_pb = alive_ad || born;
  float surrp = 0.f, surrm = 0.f;
  if (alive_pb) {
    const float cwf = (float)p.cw;
    const float half = (float)p.cw * 0.5f;
    const float chx = __fdiv_rn(__fsub_rn(__fdiv_rn(born ? bx : px, p.cell_dim), half), cwf);
    const float chy = __fdiv_rn(__fsub_rn(__fdiv_rn(born ? by : py, p.cell_dim), half), cwf);
    const float fx = floorf(chx), fy = floorf(chy), gx = ceilf(chx), gy = ceilf(chy);
    const float xi = __fsub_rn(chx, fx), yi = __fsub_rn(chy, fy);
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

  // 7. species counts and health sums
  const int sp_pb = born ? cls + 1 : species;
  const int h_pb = born ? p.child_health : health;
  if (alive_pb && sp_pb >= 1 && sp_pb <= NS) {
    atomicAdd(&cnt[sp_pb - 1], 1);
    atomicAdd(&hs[sp_pb - 1], h_pb);
  }
  __syncthreads();

  // 8. respawn from the free slots left after births
  const int needed = max(p.FL - cnt[cls], 0);
  const int free2_rank = free_rank - grant_cnt;
  const bool resp = free0 && !born && free2_rank < needed;
  const size_t draw = (size_t)w * NS * p.FL + cls * p.FL + free2_rank;

  if (valid) {
    eaten_out[row] = eaten;
    breeder_out[row] = breeder;
    born_out[row] = born;
    bposx_out[row] = bx;
    bposy_out[row] = by;
    resp_out[row] = resp;
    rposx_out[row] = resp ? drawx[draw] : 0.f;
    rposy_out[row] = resp ? drawy[draw] : 0.f;
    surrp_out[row] = surrp;
    surrm_out[row] = surrm;
  }
  for (int i = a; i < NS; i += nt) {
    counts_out[(size_t)w * NS + i] = cnt[i];
    hsum_out[(size_t)w * NS + i] = hs[i];
  }
  for (int i = a; i < CP; i += nt) consumed_out[(size_t)w * CP + i] = cons[i];
}

}  // namespace

extern "C" int mbots_systems(
    const void* alive0, const void* species, const void* health, const void* posx,
    const void* posy, const void* speedq, const void* cidx, const void* cell,
    const void* food_count, const void* food_cell, const void* drawx,
    const void* drawy, const void* dmg, const void* breed_ok, void* eaten,
    void* breeder, void* born, void* bposx, void* bposy, void* respawned,
    void* rposx, void* rposy, void* surrp, void* surrm, void* counts, void* hsum,
    void* consumed, int W, int A, int ncx, int ncy, int cw, int P, int NS, int FL,
    int shoot_damage, int eat_health, int breed_min_health, int breed_cost,
    int child_health, float cell_dim, void* stream) {
  const Params p{A, ncx, ncy, cw, P, NS, FL, shoot_damage, eat_health,
                 breed_min_health, breed_cost, child_health, cell_dim};
  const int C = ncx * ncy;
  const int threads = (A + 31) / 32 * 32;
  const size_t smem = sizeof(int) * (3 * C * P + 3 * C + 3 * A + 4 * NS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        systems_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  systems_kernel<<<W, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)alive0, (const int*)species, (const int*)health,
      (const float*)posx, (const float*)posy, (const int*)speedq, (const int*)cidx,
      (const int*)cell, (const int*)food_count, (const int*)food_cell,
      (const float*)drawx, (const float*)drawy, (const int*)dmg,
      (const uint8_t*)breed_ok, (uint8_t*)eaten, (uint8_t*)breeder, (uint8_t*)born,
      (float*)bposx, (float*)bposy, (uint8_t*)respawned, (float*)rposx,
      (float*)rposy, (float*)surrp, (float*)surrm, (int*)counts, (int*)hsum,
      (uint8_t*)consumed, p);
  return (int)cudaGetLastError();
}
