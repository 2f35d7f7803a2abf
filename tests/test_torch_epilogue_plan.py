"""B5's z-walking schedules, on the CPU.

The step's CUDA kernel (``csrc/fused_step.cu:lbm_epilogue_stage``, under
``plan``) gives each block ``NT`` consecutive cells of a plane, one thread a
cell, and walks a strip of zb planes, storing each cell's f'/g'; with
``emit_mac`` the prologue's launch on the stored f'/g' follows.  At each
plane a thread copies all its loads (the 19 + 19 pulls of f and g, the 15
macro channels) into its own stage in shared memory, then collides; in
bfloat16 storage each copy is the aligned pair that holds the value, with a
bit that names the half, and a pair that would reach outside the array is
loaded instead.

It cannot run here, so ``replay`` walks the same schedule in PyTorch: every
block and strip, the same sources in the same order (the wrap of
``lbm_pull_offsets``), a stage that starts as NaN and is tagged with the
plane it holds, and every cell read exactly once.  The replay
assembles what each cell read (its pulls after the bounce, its macros) and
the plain collide runs on that, so the test is of the schedule and the
loads: f'/g' at 1e-12 of the plain version in float64, and bit for bit in
bfloat16, where the emission also equals ``lbm_prologue_plain`` on the
replay's own stored f'/g'.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbm_ferrofluid_tpu_torch.lattice import D3Q19  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.collide import hcz_collide  # noqa: E402
from lbm_ferrofluid_tpu_torch.ops.kernels import fused_step  # noqa: E402

#: SMs of an H100 SXM
SMS = 132
OBS, FLUID = 2, 1
RG, RF = 0.02381, 0.2508
MAC_CONSTS = (1.0, RG, RF, RG, RF)
KW = dict(tau_f=0.68, tau_g=0.7, dx=1.0, dt=1.0)
EX, EY, EZ = (D3Q19.e[:, d].astype(int).tolist() for d in range(3))
OPP = D3Q19.opposite.tolist()


def sources(res, z, cells):
    """lbm_pull_offsets and lbm_pull_at: the index within a channel that
    each channel of the cells ``cells`` (in row-major order of plane z)
    pulls, [19, n]."""
    Z, Y, X = res
    XY = X * Y
    y, x = cells // X, cells % X
    off = {
        ("x", 1): torch.where(x == 0, X - 1, -1), ("x", -1): torch.where(x == X - 1, 1 - X, 1),
        ("y", 1): torch.where(y == 0, (Y - 1) * X, -X),
        ("y", -1): torch.where(y == Y - 1, (1 - Y) * X, X),
        ("z", 1): (Z - 1) * XY if z == 0 else -XY, ("z", -1): (1 - Z) * XY if z == Z - 1 else XY,
    }
    i = z * XY + cells
    out = []
    for q in range(19):
        src = i.clone()
        for axis, e in (("x", EX[q]), ("y", EY[q]), ("z", EZ[q])):
            if e:
                src = src + off[(axis, e)]
        out.append(src)
    return torch.stack(out)


def stage_words(a, idx):
    """lbm_cp_word: for each value a.flatten()[idx], the pair of values
    its copy brings into the stage and whether it is the high half.  In
    float32 and float64 a copy is the value (the other half NaN); in
    bfloat16 it is the aligned pair that holds it (from the storage, so a
    view's offset counts), or the value itself where the pair would reach
    outside the array."""
    flat = a.flatten()
    nan = torch.full(idx.shape, float("nan"), dtype=torch.float64)
    if a.dtype != torch.bfloat16:
        return torch.stack([flat[idx].double(), nan]), torch.zeros_like(idx, dtype=torch.bool)
    storage = torch.as_strided(a, (a.untyped_storage().nbytes() // 2,), (1,), 0).double()
    e = idx + a.storage_offset()
    hi = (e % 2) == 1
    w = e - hi.long()
    inside = (w >= a.storage_offset()) & (w + 2 <= a.storage_offset() + a.numel())
    lo_v = torch.where(inside, storage[w.clamp(max=storage.numel() - 1)], nan)
    hi_v = torch.where(inside, storage[(w + 1).clamp(max=storage.numel() - 1)], nan)
    v = flat[idx].double()
    lo_v = torch.where(~inside & ~hi, v, lo_v)
    hi_v = torch.where(~inside & hi, v, hi_v)
    return torch.stack([lo_v, hi_v]), hi


def replay(f, g, flags, macros, pl, prefetch=False):
    """B5 under ``pl`` as the kernel schedules it: what each cell read,
    (f, g pulled and bounced [1, 19, Z, Y, X], the 15 macro channels [15,
    N]) in float64, every cell of every block and strip read once.  In the
    stage form the copies of plane z are issued into the thread's stage,
    then read; with ``prefetch`` those of plane z + 1 are issued before
    plane z is read, and a copy into a stage not read yet fails."""
    _, _, Z, Y, X = f.shape
    XY, N = X * Y, X * Y * Z
    mac = torch.cat([m.reshape(-1, N) for m in macros]).double()   # [15, N]
    read = [torch.full((19, N), float("nan"), dtype=torch.float64) for _ in range(2)]
    read_mac = torch.full((15, N), float("nan"), dtype=torch.float64)
    times = torch.zeros(N, dtype=torch.int64)
    fl = flags.reshape(-1)
    nt, zb = (N, Z) if pl.form == "cell" else (fused_step.NT, pl.zb)
    for bz in range(-(-Z // zb)):
        z0, z1 = bz * zb, min(bz * zb + zb, Z)
        for b in range(-(-XY // nt)):
            cells = torch.arange(b * nt, min(b * nt + nt, XY))
            stage = []   # [plane, words, half bits, macros, read yet]

            def issue(z):
                assert not stage or stage[4], f"plane {z} overwrote an unread stage"
                src = sources((Z, Y, X), z, cells)
                words, bits = zip(*(stage_words(a, src + torch.arange(19)[:, None] * N)
                                    for a in (f, g)))
                stage[:] = [z, words, bits, mac[:, z * XY + cells], False]

            def read_plane(z):
                assert stage and stage[0] == z, f"the stage of plane {z} holds another"
                stage[4] = True
                return [torch.where(h, w[1], w[0]) for w, h in zip(stage[1], stage[2])], stage[3]

            for z in range(z0, z1):
                i = z * XY + cells
                if pl.form == "stage":
                    if not prefetch or z == z0:
                        issue(z)
                    if prefetch and z + 1 < z1:
                        issue(z + 1)
                    vals, m = read_plane(z)
                else:   # the cell form pulls from device memory
                    src = sources((Z, Y, X), z, cells)
                    vals = [a.reshape(19, N).double().gather(1, src) for a in (f, g)]
                    m = mac[:, i]
                obs = fl[i] == OBS
                for d in range(2):
                    bounced = torch.where(obs, vals[d][OPP], vals[d])
                    assert bool(torch.isnan(read[d][:, i]).all())
                    read[d][:, i] = bounced
                read_mac[:, i] = m
                times[i] += 1
    assert bool((times == 1).all()), "a cell read twice or never"
    assert not any(bool(torch.isnan(r).any()) for r in (*read, read_mac)), "a load never made"
    return read[0].reshape(1, 19, Z, Y, X), read[1].reshape(1, 19, Z, Y, X), read_mac


def collide_read(f, g, flags, f_post, g_post, read_mac):
    """The plain collide on what the replay's cells read, f'/g' in the
    storage type of f and g: lbm_epilogue_cell's arithmetic."""
    _, _, Z, Y, X = f.shape
    wide = torch.float64 if f.dtype == torch.float64 else torch.float32
    m = read_mac.to(wide).reshape(15, 1, 1, Z, Y, X)
    vec = lambda a: torch.cat(list(m[a:a + 3]), dim=1)   # noqa: E731
    f_n, g_n = hcz_collide(D3Q19, f_post.to(f.dtype), g_post.to(g.dtype), m[0], vec(1), m[4],
                           m[5], flags, vec(6), vec(9), vec(12), **KW)
    return f_n, g_n


def inputs(res, zb, dtype, seed):
    """Seeded fields: fluid with obstacles across the first block edge (in
    row-major order of a plane) and the first strip seam of strips of zb,
    obstacles on the x = 0 column of the first plane (the x and z wraps)
    and one cell of another kind; near-equilibrium f and g and a capillary
    stage's outputs."""
    Z, Y, X = res
    rng = np.random.default_rng(seed)
    fl = np.full((1, 1, *res), FLUID, np.uint8)
    zs = slice(max(zb - 1, 0), zb + 1)
    for cell in (fused_step.NT - 1, fused_step.NT):
        if cell < Y * X:
            fl[..., zs, cell // X, cell % X] = OBS
    fl[..., 0, :, 0] = OBS
    fl[..., Z - 1, Y - 1, X // 2] = 3
    rho = RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res))
    w = D3Q19.w_bcast(np.float64)
    d = dict(
        f=w * rho * (1.0 + 0.1 * rng.standard_normal((1, 19, *res))),
        g=w * 0.02 * (1.0 + 0.1 * rng.standard_normal((1, 19, *res))),
        flags=fl, rho=rho,
        vel=rng.uniform(-0.02, 0.02, (1, 3, *res)),
        den=RG + (RF - RG) * rng.uniform(0.0, 1.0, (1, 1, *res)),
        pres=rng.uniform(0.01, 0.03, (1, 1, *res)),
        force=rng.uniform(-1e-4, 1e-4, (1, 3, *res)),
        dfai=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
        dprho=rng.uniform(-1e-3, 1e-3, (1, 3, *res)),
    )
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    return [t["f"].to(dtype), t["g"].to(dtype), t["flags"],
            *(t[k].to(wide) for k in ("rho", "vel", "den", "pres", "force", "dfai", "dprho"))]


def rel(a, b):
    return float((a.double() - b.double()).abs().max()) / float(b.double().abs().max())


#: (grid, strip): a last block of one cell (513 = 2 x 256 + 1), of a few
#: cells (297 = 256 + 41, 645 = 2 x 256 + 133, 387 = 256 + 131), a plane
#: smaller than a block (128), Z = 4, strips of one plane, a last strip of
#: one plane ending at Z - 1 (7 = 3 + 3 + 1, 9 = 4 + 4 + 1), one strip for
#: the whole of z, and odd X, Y and Z (bfloat16 pairs across rows, planes
#: and channels)
CASES = [
    ((4, 9, 33), 4), ((5, 5, 129), 2), ((7, 10, 34), 3), ((6, 17, 40), 1),
    ((9, 18, 66), 4), ((4, 8, 16), 3), ((6, 3, 129), 6), ((5, 19, 27), 2),
]
IDS = ["x".join(map(str, r)) + f"-zb{zb}" for r, zb in CASES]


@pytest.mark.parametrize("form", ["cell", "stage", "stage_emit_mac"])
@pytest.mark.parametrize("res,zb", CASES, ids=IDS)
def test_schedule_equals_plain_f64(res, zb, form):
    """The cell form and the stage form (whose emission is the prologue's
    launch on the stored f'/g'): f'/g' and the emission at 1e-12 of the
    plain version."""
    pl = fused_step.EpiloguePlan(form.split("_")[0], zb)
    emit_mac = form.endswith("emit_mac")
    args = inputs(res, zb, torch.float64, sum(res))
    want = fused_step.lbm_epilogue_plain(*args, emit_mac=True, mac_consts=MAC_CONSTS, **KW)
    f_n, g_n = collide_read(args[0], args[1], args[2], *replay(*args[:3], args[3:], pl))
    assert rel(f_n, want[0]) <= 1e-12 and rel(g_n, want[1]) <= 1e-12
    if emit_mac:
        mac = fused_step.lbm_prologue_plain(f_n, g_n, args[2], args[3], args[4],
                                            c=MAC_CONSTS[0], rho_gas=RG, rho_fluid=RF,
                                            density_gas=RG, density_fluid=RF)
        for name, a, b in zip(("rho", "vel", "density", "m0g", "m1g"), mac, want[2],
                              strict=True):
            assert rel(a, b) <= 1e-12, name
    # the wrapper on CPU tensors is the plain version
    got = fused_step.lbm_epilogue(*args, emit_mac=emit_mac, mac_consts=MAC_CONSTS, **KW)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))


def offset_view(t, offset):
    """``t`` copied into a view that starts ``offset`` elements into its
    storage (a view whose bfloat16 pairs start one value off)."""
    big = torch.empty(t.numel() + offset, dtype=t.dtype)
    v = big[offset:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("res,zb", CASES[4:], ids=IDS[4:])
def test_bf16_stage_pairs_bit_for_bit(res, zb, offset):
    """The stage form in bfloat16 storage, each copy the pair that holds the
    value (views whose pairs start on a value or one off): f'/g' bit for
    bit the plain version's, and the emission bit for bit the plain
    prologue on the replay's own stored f'/g'."""
    args = inputs(res, zb, torch.bfloat16, sum(res) + 1)
    args[:2] = [offset_view(a, offset) for a in args[:2]]
    want = fused_step.lbm_epilogue_plain(*args, emit_mac=True, mac_consts=MAC_CONSTS, **KW)
    f_n, g_n = collide_read(args[0], args[1], args[2],
                            *replay(*args[:3], args[3:], fused_step.EpiloguePlan("stage", zb)))
    assert f_n.dtype == g_n.dtype == torch.bfloat16
    assert torch.equal(f_n, want[0]) and torch.equal(g_n, want[1])
    mac = fused_step.lbm_prologue_plain(f_n, g_n, args[2], args[3], args[4], c=MAC_CONSTS[0],
                                        rho_gas=RG, rho_fluid=RF, density_gas=RG,
                                        density_fluid=RF)
    for a, b in zip(mac, want[2], strict=True):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_stage_is_read_before_the_next_copies():
    """A thread has one stage: the copies of plane z + 1 may be issued only
    after plane z is read.  Issued before (a prefetch into the same
    stage), they would overwrite it, and the replay reports it."""
    res, zb = (6, 9, 66), 3
    args = inputs(res, zb, torch.float64, 3)
    replay(*args[:3], args[3:], fused_step.EpiloguePlan("stage", zb))
    with pytest.raises(AssertionError, match="overwrote an unread stage"):
        replay(*args[:3], args[3:], fused_step.EpiloguePlan("stage", zb), prefetch=True)


def test_kernel_constants_are_the_cuda_sources():
    """NT, STAGE_WORDS and REGS are EP_NT, EP_WORDS and EP_REGS of
    csrc/fused_step.cu; FORMS is the order of lbm_epilogue_launch's forms;
    two stage blocks fit an SM's 228 KiB of shared memory (1 KiB a block
    reserved) and its registers."""
    src = (Path(fused_step.__file__).parents[2] / "csrc" / "fused_step.cu").read_text()
    assert int(re.search(r"#define EP_NT (\d+)", src)[1]) == fused_step.NT == 256
    assert int(re.search(r"#define EP_WORDS (\d+)", src)[1]) == fused_step.STAGE_WORDS == 55
    assert int(re.search(r"#define EP_REGS (\d+)", src)[1]) == fused_step.REGS == 128
    assert "#define EP_STAGE_BYTES (EP_WORDS * EP_NT * 4)" in src
    assert "// form: 0 the cell plan, 1 the stage form" in src
    assert fused_step.FORMS == ("cell", "stage")
    assert re.search(r"__launch_bounds__\(EP_NT, 65536 / \(EP_REGS \* EP_NT\)\) "
                     r"lbm_epilogue_stage\(", src)
    stage = fused_step.STAGE_WORDS * fused_step.NT * 4
    assert fused_step.blocks_per_sm(fused_step.NT) == 2
    assert 2 * (stage + 1024) <= 228 * 1024
    # the words: 19 + 19 pulls, two words of half bits, 15 macro channels
    assert fused_step.STAGE_WORDS == 19 + 19 + 2 + 15


GRIDS = [(256, 256, 256), (130, 66, 130), (130, 130, 130), (50, 50, 193), (34, 66, 130),
         (4, 66, 130), (4, 8, 16), (512, 512, 512)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("res", GRIDS, ids=lambda r: "x".join(map(str, r)))
def test_plan_covers_the_grid(res, bf16):
    Z, Y, X = res
    pl = fused_step.plan(Z, Y, X, SMS, bf16)
    assert pl.form == "stage" and 1 <= pl.zb <= min(Z, fused_step.MAX_STRIP)
    if not bf16:
        assert pl.zb == 1
        return
    # no other strip needs fewer waves of resident blocks times planes
    blocks = -(-X * Y // fused_step.NT)
    resident = SMS * fused_step.blocks_per_sm(fused_step.NT)
    ticks = lambda zb: (-(-blocks * -(-Z // zb) // resident)   # noqa: E731
                        * (zb + fused_step.STRIP_START))
    assert all(ticks(zb) >= ticks(pl.zb) for zb in range(1, min(Z, fused_step.MAX_STRIP) + 1))


def test_plan_at_256_and_130():
    """The plans that timed best in the sweep (chip_smoke.py
    --epilogue-plans): one plane a block in float32, strips of 4 planes at
    256^3 and of one at 130x66x130 in bfloat16."""
    assert fused_step.plan(256, 256, 256, SMS, False) == ("stage", 1)
    assert fused_step.plan(130, 66, 130, SMS, False) == ("stage", 1)
    assert fused_step.plan(256, 256, 256, SMS, True) == ("stage", 4)
    assert fused_step.plan(130, 66, 130, SMS, True) == ("stage", 1)
    # the collide's 128 registers a thread: two 256-thread blocks an SM
    assert fused_step.blocks_per_sm(256) == 2
