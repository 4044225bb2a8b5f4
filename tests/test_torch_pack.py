"""The port's learner-row compaction (learn/pack.py) and the row-gather
kernel's plain version against the JAX package, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_bots_tpu.learn import pack as jpack
from madrona_bots_tpu.ops.row_gather import compact_fields as jax_compact_fields
from madrona_bots_tpu.ops.row_gather import kslot_from_class_slots as jax_kslot
from madrona_bots_tpu_torch.learn import pack
from madrona_bots_tpu_torch.ops import row_gather_cuda

W, A, NS = 4, 64, 4
ASUB, G = A // NS, NS * W


def masks(density, seed):
    return np.random.default_rng(seed).random((G, ASUB)) < density


def bits(x):
    """Raw bits of a numpy / JAX array or a torch tensor (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


@pytest.mark.parametrize("rows", [3, 5, 16])
@pytest.mark.parametrize("density", [0.2, 0.6, 1.0])
def test_compact_slots_bit_exact(density, rows):
    m = masks(density, int(density * 10) + rows)
    want = jpack.compact_slots(jnp.asarray(m), rows)
    got = pack.compact_slots(torch.from_numpy(m), rows)
    for name, w, g in zip(("slot", "valid", "keep"), want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)
    if density == 1.0 and rows < ASUB:
        assert not got[2].all()                                   # overflow dropped


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("rows", [3, 5])
def test_compact_gather_and_expand_scatter(dtype, rows):
    m = masks(0.5, rows)
    jslot, jvalid, _ = jpack.compact_slots(jnp.asarray(m), rows)
    slot, valid, _ = pack.compact_slots(torch.from_numpy(m), rows)
    r = np.random.default_rng(rows)
    x = r.normal(size=(G, ASUB, 7)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    want = np.asarray(jpack.compact_gather(jx, jslot, jvalid))
    got = pack.compact_gather(tx, slot, valid)
    v = valid.numpy()[..., None]
    # JAX's f32 gather copies slot 0 into rows past the count; the port
    # zeroes them, as its bf16 path does.
    np.testing.assert_array_equal(bits(np.where(v, want, 0).astype(want.dtype)), bits(got))
    assert not got.float()[~valid].any()
    src = r.normal(size=(G, rows, 5)).astype(np.float32)
    js = jnp.asarray(src, jx.dtype)
    ts = torch.from_numpy(src).to(tx.dtype)
    want = np.asarray(jpack.expand_scatter(js, jslot, jvalid, ASUB))
    got = pack.expand_scatter(ts, slot, valid, ASUB)
    np.testing.assert_array_equal(bits(want), bits(got))


def test_split3_exact():
    """Bit-exact where all three planes are normal floats, and on zeros.
    XLA:CPU flushes denormal residuals (|x| below ~2^-110) to zero; rewards
    never come near."""
    r = np.random.default_rng(0)
    x = np.concatenate([r.normal(size=4000) * 10.0 ** r.integers(-25, 30, 4000),
                        [0.0, -0.0, 1.0, 3.0e38, 1e-30]]).astype(np.float32)
    want = jax.jit(jpack.split3)(jnp.asarray(x))
    got = pack.split3(torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(bits(w), bits(g))
    total = got[0].float() + got[1].float() + got[2].float()
    np.testing.assert_array_equal(total.numpy(), x)


@pytest.mark.parametrize("rows", [3, 5])
def test_kslot_from_class_slots(rows):
    m = masks(0.5, 10 + rows)
    jslot, jvalid, _ = jpack.compact_slots(jnp.asarray(m), rows)
    slot, valid, _ = pack.compact_slots(torch.from_numpy(m), rows)
    want = np.asarray(jax_kslot(jslot, jvalid, W, NS))
    got = pack.kslot_from_class_slots(slot, valid, W, NS)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(want, got.numpy())


def fields(seed, A_=A):
    r = np.random.default_rng(seed)
    out = [r.integers(0, 256, (W, A_, 32)).astype(np.uint8),
           r.integers(-1, 5, (W, A_, 32)).astype(np.int8),
           (r.normal(size=(W, A_, 15)) * 50).astype(np.float32),
           r.integers(0, 257, (W, A_, 3)).astype(np.int32)]
    return out


@pytest.mark.parametrize("density", [0.3, 0.8])
def test_row_gather_plain_matches_compact_fields(density):
    """The plain version against the Pallas kernel in interpret mode, on
    every source dtype, with overflow and invalid (-1) rows."""
    rows = 5
    m = masks(density, int(density * 10))
    jslot, jvalid, _ = jpack.compact_slots(jnp.asarray(m), rows)
    kslot_j = jax_kslot(jslot, jvalid, W, NS)
    slot, valid, _ = pack.compact_slots(torch.from_numpy(m), rows)
    kslot = pack.kslot_from_class_slots(slot, valid, W, NS)
    u8, i8, flt, i32 = fields(int(density * 10))
    jf = [jnp.asarray(u8), jnp.asarray(i8), jnp.asarray(flt, jnp.bfloat16), jnp.asarray(i32)]
    tf = [torch.from_numpy(u8), torch.from_numpy(i8),
          torch.from_numpy(flt).to(torch.bfloat16), torch.from_numpy(i32)]
    want = jax_compact_fields(kslot_j, jf, interpret=True)
    got = row_gather_cuda.compact_fields_reference(kslot, tf)
    for w, g in zip(want, got):
        assert g.dtype == torch.bfloat16 and g.shape == (W, NS * rows, w.shape[-1])
        np.testing.assert_array_equal(bits(w), bits(g))


def test_row_gather_wrapper_on_cpu_and_checks():
    r = np.random.default_rng(4)
    kslot = torch.from_numpy(r.integers(-1, 16, (2, 6)).astype(np.int32))
    x = torch.from_numpy(r.integers(0, 256, (2, 16, 4)).astype(np.uint8))
    before = row_gather_cuda.launches
    (got,) = row_gather_cuda.compact_fields(kslot, [x])
    assert row_gather_cuda.launches == before
    want = jax_compact_fields(jnp.asarray(kslot.numpy()), [jnp.asarray(x.numpy())],
                              interpret=True)[0]
    np.testing.assert_array_equal(bits(want), bits(got))
    assert not got[kslot < 0].float().any()
    with pytest.raises(ValueError):
        row_gather_cuda.compact_fields(kslot.long(), [x])
    with pytest.raises(ValueError):
        row_gather_cuda.compact_fields(kslot, [x.float()])
    with pytest.raises(ValueError):
        row_gather_cuda.compact_fields(kslot, [x[:, :8]])
    with pytest.raises(ValueError):
        row_gather_cuda.compact_fields(kslot, [x] * 9)


def _at_offset(shape, dtype, offset):
    """A contiguous tensor whose data starts `offset` elements into an
    aligned buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("width, dtype, src_off, dst_off, want", [
    (32, torch.uint8, 0, 0, 8),        # depth / semantic bytes: 8-byte loads, 16-byte stores
    (32, torch.int8, 0, 0, 8),
    (16, torch.bfloat16, 0, 0, 8),     # memory: two 16-byte copies a row
    (8, torch.int32, 0, 0, 8),
    (15, torch.bfloat16, 0, 0, 1),     # the scalar field: 30-byte rows
    (1, torch.uint8, 0, 0, 1),
    (6, torch.int8, 0, 0, 1),          # width not a multiple of 8
    (32, torch.uint8, 2, 0, 1),        # source only 2-byte aligned
    (32, torch.uint8, 1, 0, 1),
    (16, torch.bfloat16, 2, 0, 1),
    (16, torch.bfloat16, 1, 0, 1),
    (8, torch.int32, 2, 0, 1),
    (32, torch.uint8, 0, 2, 1),        # destination only 4-byte aligned
    (32, torch.uint8, 0, 1, 1),
    (24, torch.uint8, 0, 8, 8),        # destination 16-byte aligned
    (8, torch.int32, 4, 0, 8),
])
def test_row_gather_vector_width(width, dtype, src_off, dst_off, want):
    """The per-field access width the wrapper hands the kernel, from the
    field's width and its pointers' alignment."""
    src = _at_offset((2, 4, width), dtype, src_off)
    dst = _at_offset((2, 3, width), torch.bfloat16, dst_off)
    got = row_gather_cuda.vector_width(width, src.element_size(), src.data_ptr(),
                                       dst.data_ptr())
    assert got == want
    assert width % got == 0 and dst.data_ptr() % (2 * got) == 0
    assert src.data_ptr() % min(16, got * src.element_size()) == 0


def test_row_gather_plan_for_the_a2c_fields():
    """The bf16 tick's seven fields: the four byte fields and both memories
    take 16-byte stores, the 15-wide scalar field 2-byte ones; a block
    covers enough whole worlds to write BLOCK_BYTES."""
    widths = [32, 32, 32, 32, 15, 16, 16]
    dtypes = [torch.uint8, torch.int8, torch.uint8, torch.int8] + [torch.bfloat16] * 3
    W_, A_, K = 3, 8, 40
    srcs = [torch.zeros((W_, A_, d), dtype=t) for d, t in zip(widths, dtypes)]
    outs = [torch.empty((W_, K, d), dtype=torch.bfloat16) for d in widths]
    assert [row_gather_cuda.vector_width(d, s.element_size(), s.data_ptr(), o.data_ptr())
            for d, s, o in zip(widths, srcs, outs)] == [8, 8, 8, 8, 1, 8, 8]
    for k in (40, 12, 1):
        wpb = row_gather_cuda.worlds_per_block(k, widths)
        per_world = 2 * k * sum(widths)
        assert wpb * per_world >= row_gather_cuda.BLOCK_BYTES
        assert (wpb - 1) * per_world < row_gather_cuda.BLOCK_BYTES
    assert row_gather_cuda.worlds_per_block(40, widths) == 1
    assert row_gather_cuda.worlds_per_block(12, widths) == 2
    assert row_gather_cuda.worlds_per_block(10_000, widths) == 1
    assert row_gather_cuda.worlds_per_block(0, widths) == 1


def test_row_gather_wrapper_device_checks():
    """Fields on another device than kslot, or tensors on neither the CPU
    nor a card, raise before any launch; seven CPU fields take the plain
    version without counting a launch."""
    r = np.random.default_rng(5)
    kslot = torch.from_numpy(r.integers(-1, 16, (2, 12)).astype(np.int32))
    fields = [torch.from_numpy(r.integers(0, 256, (2, 16, 32)).astype(np.uint8)),
              torch.from_numpy(r.integers(-1, 5, (2, 16, 32)).astype(np.int8)),
              torch.from_numpy(r.normal(size=(2, 16, 15)).astype(np.float32)).to(torch.bfloat16),
              torch.from_numpy(r.integers(0, 257, (2, 16, 1)).astype(np.int32))]
    before = row_gather_cuda.launches
    got = row_gather_cuda.compact_fields(kslot, fields)
    assert row_gather_cuda.launches == before
    for g, w in zip(got, row_gather_cuda.compact_fields_reference(kslot, fields)):
        assert g.shape == (2, 12, w.shape[-1])
        np.testing.assert_array_equal(bits(w), bits(g))
    with pytest.raises(ValueError):
        row_gather_cuda.compact_fields(kslot, [fields[0].to("meta")])
    with pytest.raises(ValueError):
        row_gather_cuda.compact_fields(kslot.to("meta"), [f.to("meta") for f in fields])
    with pytest.raises(ValueError):
        row_gather_cuda.compact_fields(kslot, [fields[0][:, :, :8]])   # not contiguous
    with pytest.raises(ValueError):
        row_gather_cuda.compact_fields(kslot[:1], fields)               # W differs
    assert row_gather_cuda.launches == before


def test_health_bits_column_matches_jax():
    """Q2: health's int32 bits read as f32 (denormals for small healths),
    then cast to bf16, as the jitted JAX tick does."""
    h = np.arange(-5, 400, dtype=np.int32)
    want = jax.jit(lambda x: jax.lax.bitcast_convert_type(x, jnp.float32)
                   .astype(jnp.bfloat16))(jnp.asarray(h))
    got = torch.from_numpy(h).view(torch.float32).to(torch.bfloat16)
    np.testing.assert_array_equal(bits(want)[h >= 0], bits(got)[h >= 0])


@pytest.fixture(scope="module")
def stepped_states():
    """A JAX state after 6 random steps and a shift, with random memory,
    and the same state in the port."""
    from madrona_bots_tpu import EnvConfig as JaxConfig
    from madrona_bots_tpu import init_state as jax_init_state
    from madrona_bots_tpu.env import env as jenv
    from madrona_bots_tpu_torch.config import EnvConfig
    from madrona_bots_tpu_torch.env.state import state_from_numpy
    from test_oracle_parity import random_actions
    from test_torch_state import jax_arrays

    kw = dict(num_worlds=W, init_agents=32, max_agents=A)
    jcfg = JaxConfig(**kw)
    js = jax_init_state(jax.random.key(6), jcfg)
    r = np.random.default_rng(6)
    for t in range(6):
        js = jenv.step(jenv.set_actions(js, jnp.asarray(random_actions(r, W, A))), jcfg)
        if t == 3:
            js = jenv.shift_observations(js, jcfg)
    alive = np.asarray(js.alive)[..., None]
    js = js.replace(hidden=jnp.asarray(np.where(alive, r.normal(size=(W, A, 16)), 0),
                                       jnp.float32),
                    prev_hidden=jnp.asarray(r.normal(size=(W, A, 16)), jnp.float32))
    return js, jcfg, state_from_numpy(jax_arrays(js), device="cpu"), EnvConfig(**kw)


@pytest.mark.parametrize("quirk_compat", [False, True])
def test_bf16_tick_payload_matches_jax(stepped_states, quirk_compat):
    """The bf16 tick's compacted learner payload (the row gather over its
    seven fields, reassembled) equals, bit for bit, the payload the JAX tick
    builds (its einsum path, a2c.py:343-358, which the JAX tests hold equal
    to its Pallas row-gather path) on the same state."""
    from madrona_bots_tpu.learn.obs import obs_field_cols
    from madrona_bots_tpu_torch.learn.a2c import compact_learner_rows

    js, jcfg, ts, tcfg = stepped_states
    rows, bf = 5, jnp.bfloat16

    @jax.jit
    def jax_payload(js):
        spec_tile = jnp.tile(jnp.arange(1, NS + 1, dtype=js.species.dtype), ASUB)
        m_full = js.alive & (js.species == spec_tile[None, :])
        lm_full = m_full & (js.prev_species == spec_tile[None, :])

        def cmaj(x):
            x4 = x.reshape((W, ASUB, NS) + x.shape[2:])
            return x4.transpose((2, 0, 1) + tuple(range(3, x4.ndim))).reshape(
                (G, ASUB) + x.shape[2:])

        slot, valid, _ = jpack.compact_slots(cmaj(m_full), rows)
        cols = obs_field_cols(js, jcfg, prev=False, quirk_compat=quirk_compat, dtype=bf)
        cols += obs_field_cols(js, jcfg, prev=True, quirk_compat=quirk_compat, dtype=bf)
        cols += [js.hidden.astype(bf), js.prev_hidden.astype(bf),
                 lm_full[..., None].astype(bf),
                 jnp.argmax(js.action, axis=-1)[..., None].astype(bf)]
        cols += [p[..., None] for p in jpack.split3(js.reward)]
        grec = jpack.compact_gather(cmaj(jnp.concatenate(cols, axis=-1)), slot, valid)
        return grec.reshape(NS, W, rows, grec.shape[-1])

    want = jax_payload(js)
    got = compact_learner_rows(ts.clone(), tcfg, rows, torch.bfloat16, quirk_compat)[0]
    assert got.shape == want.shape == (NS, W, rows, 2 * 69 + 2 * 16 + 5)
    np.testing.assert_array_equal(bits(want), bits(got.contiguous()))
    assert bool((got[..., 2 * 69:2 * 69 + 16] != 0).any())      # memory travelled
