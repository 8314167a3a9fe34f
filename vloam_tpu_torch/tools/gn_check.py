"""Check and time the Gauss-Newton kernels B3 (``solve_pose_gn_lidar``,
``csrc/gn_lidar.cu``) and B4 (``solve_pose_gn_vo``, ``csrc/gn_vo.cu``) on
the GPU.

    python -m vloam_tpu_torch.tools.gn_check [--frame N]

drives the full step at ``kitti_hdl64`` over frames 0..N (default 15) of
the synthetic course, takes the first LO, MO and VO solve of frame N as the
step passes them, holds each kernel to its plain version (``check``) and
prints for each:

  wrapper       ms of one wrapper call by CUDA events (median of 20);
  graph         device ms a call, 20 wrapper calls captured in one CUDA graph
                and replayed;
  launch alone  the same for the kernel's launch alone, its inputs prepared
                beforehand (so graph - launch alone is the wrapper's own
                device work);
  chain floor   the launch alone with every mask cleared: what the dependent
                iterations cost whatever the data;
then the problems of ``cases``, and last the device kernels one wrapper call
runs (``torch.profiler``: once it has run, every launch in the
process costs more on the host, so it comes after all timing), and the
card.  It needs a GPU and exits nonzero without one.

    python -m vloam_tpu_torch.tools.gn_check --phases

adds, for the same solves, the cycles an iteration spends in each phase
(rows, warp reduction, block sum, the cluster's exchange, solve; thread 0
of CTA 0, averaged over the iterations), with every mask set as given and
with every mask cleared, from a second build of the kernels with
-DVLOAM_GN_PHASES (the shipped build has no counters).

    python -m vloam_tpu_torch.tools.gn_check --spread [N] [--src DIR]

prints instead how far apart the kernel, the plain version and the plain
version in float64 land over N (default 20) perturbed copies of each solve
(``spread``): what the tolerance below is set from.  ``--src`` builds the
kernels from another copy of ``csrc/`` (a variant under trial).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from vloam_tpu_torch import kernels
from vloam_tpu_torch.ops import fused_gn
from vloam_tpu_torch.ops.gauss_newton import pose_plus
from vloam_tpu_torch.tools.gather_experiments import card_line, graph_ms, time_ms

# kernel vs plain version on the card: translation within T_TOL (m) or
# T_EPS float32 epsilons of the translation's size, whichever is larger;
# each quaternion component, sign-aligned, and 1 - |q . q'| within Q_TOL.
# The mapping pose lies 12 m (frame 15) to 28 m (frame 35) from the origin,
# where one float32 step is 9.5e-7 to 1.9e-6 m, so the two versions can sit
# one step apart there; LO's and VO's poses (~0.8 m) are held to T_TOL.
# ``spread`` measures the gaps: over perturbed copies of frame 15's solves
# at most one eps |t| for MO and ~9 eps |t| (9e-7 m) for LO and VO, where
# the plain version itself lies up to ~6.5 eps |t| from its float64 result.
T_TOL = 1.1e-6
T_EPS = 4
Q_TOL = 1e-6
PHASES = {
    "lidar": ("rows", "warp reduction", "block sum", "push + cluster barrier",
              "slot sums + broadcast", "solve"),
    "vo": ("rows", "warp reduction", "block sum", "broadcast", "solve"),
}

SOLVES = {
    "lidar": (fused_gn.solve_pose_gn_lidar, fused_gn.solve_pose_gn_lidar_reference),
    "vo": (fused_gn.solve_pose_gn_vo, fused_gn.solve_pose_gn_vo_reference),
}


def check(label: str, kind: str, args, want_pose=None) -> float:
    """The kernel against its plain version on ``args``; with ``want_pose``
    also against that pose.  Returns the largest absolute difference."""
    kernel, plain = SOLVES[kind]
    got = kernel(*args)
    assert bool(torch.isfinite(got).all()), f"gn_{kind} {label}: non-finite pose {got}"
    err = _close(f"gn_{kind} {label}", got, plain(*args), "the plain version")
    if want_pose is not None:
        _close(f"gn_{kind} {label}", got, want_pose, "pose0")
    return err


def _close(label, got, want, name) -> float:
    dot = float(torch.dot(got[:4], want[:4]))
    sign = 1.0 if dot >= 0 else -1.0
    dt = float((got[4:] - want[4:]).abs().max())
    dq = float((got[:4] * sign - want[:4]).abs().max())
    t_tol = max(T_TOL, T_EPS * torch.finfo(torch.float32).eps * float(want[4:].abs().max()))
    assert dt <= t_tol and dq <= Q_TOL and 1.0 - abs(dot) <= Q_TOL, \
        f"{label} vs {name}: translation {dt} (tol {t_tol}), quaternion {dq}, q.q' {dot}"
    print(f"  {label}: vs {name} translation {dt:.3e} m (tol {t_tol:.2e}), quaternion {dq:.3e}, "
          f"|q.q'| {abs(dot):.9f}")
    return max(dt, dq)


def _wide(x):
    """x as a view into a buffer one column wider: (B, w) rows at stride
    w + 1, a (B,) array at stride 2."""
    cols = x.shape[1] if x.dim() == 2 else 1
    buf = torch.zeros((x.shape[0], cols + 1), dtype=x.dtype, device=x.device)
    if x.dim() == 2:
        buf[:, :cols] = x
        return buf[:, :cols]
    buf[:, 0] = x
    return buf[:, 0]


def _rows(x, n):
    """The first n rows of x, repeated as often as it takes."""
    return torch.cat([x] * max(1, -(-n // max(x.shape[0], 1))))[:n]


def cases(lidar_args, vo_args) -> list[tuple]:
    """(label, kind, args, pose the result must keep or None) of the problems
    built from one captured call of each kind: every array a strided view of
    a wider buffer; no edges, no planes, neither; every row invalid; sizes
    that divide by no cluster or block size."""
    pose, edge, plane, *rest = lidar_args
    be, bs = edge[0].shape[0], plane[0].shape[0]
    out = [("strided views", "lidar", (pose, tuple(map(_wide, edge)), tuple(map(_wide, plane)),
                                       *rest), None)]
    for label, ne, ns in (("Be=0", 0, bs), ("Bs=0", be, 0), ("Be=0 Bs=0", 0, 0),
                          ("Be=1", 1, bs), ("Be=1023 Bs=1023", 1023, 1023),
                          ("Be=4097 Bs=8193", 4097, 8193)):
        out.append((label, "lidar", (pose, tuple(_rows(x, ne) for x in edge),
                                     tuple(_rows(x, ns) for x in plane), *rest), None))
    off = lambda m: torch.zeros_like(m)  # noqa: E731
    out.append(("every row invalid", "lidar", (pose, (*edge[:3], off(edge[3])),
                                               (*plane[:3], off(plane[3])), *rest), pose))

    pose, X0, xb0, xb1, hd, nd, *rest = vo_args
    vo = (X0, xb0, xb1, hd, nd)
    out.append(("strided views", "vo", (pose, *map(_wide, vo), *rest), None))
    for m in (0, 1023, 1025):
        out.append((f"M={m}", "vo", (pose, *(_rows(x, m) for x in vo), *rest),
                    pose if m == 0 else None))
    out.append(("every match invalid", "vo", (pose, X0, xb0, xb1, off(hd), off(nd), *rest), pose))
    return out


def launch_alone(kind: str, args, live: bool = True):
    """A function that makes the kernel's launch alone, its inputs prepared
    now; with ``live=False`` every mask is cleared first (the chain floor)."""
    lib, dev = kernels.lib(), args[0].device
    out = torch.empty(7, dtype=torch.float32, device=dev)
    if kind == "lidar":
        pose, (ep, ea, eb, ev), (pp, pn, pd, pv), iters, delta, lam = args
        if not live:
            ev, pv = torch.zeros_like(ev), torch.zeros_like(pv)
        arrays, strides, be, bs = fused_gn.lidar_layout(pose, (ep, ea, eb, ev), (pp, pn, pd, pv))
        p = [v for a, s in zip(arrays, strides) for v in (a.data_ptr(), s)]
        return lambda keep=arrays: kernels.check(lib.vloam_gn_lidar(
            *p[:10], be, *p[10:], bs, iters, delta, lam, out.data_ptr(), kernels.stream_ptr(dev)),
            "gn_lidar")
    pose, X0, xb0, xb1, hd, nd, iters, delta, lam = args
    if not live:
        hd, nd = torch.zeros_like(hd), torch.zeros_like(nd)
    arrays, strides, m = fused_gn.vo_layout(pose, X0, xb0, xb1, hd, nd)
    p = [v for a, s in zip(arrays, strides) for v in (a.data_ptr(), s)]
    return lambda keep=arrays: kernels.check(lib.vloam_gn_vo(
        *p, m, iters, delta, lam, out.data_ptr(), kernels.stream_ptr(dev)), "gn_vo")


def device_kernels(fn, tries: int = 3) -> list[str] | None:
    """Names of the device kernels one call of fn() runs, by torch.profiler;
    None where the profiler shows no device event at all in ``tries``
    profiled calls (now and then it records none for a call of a few
    microseconds)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return None


def launch_line(label: str, kind: str, args, card: str) -> str:
    """The launch alone's and the chain floor's device ms a call inside a
    replayed CUDA graph, as one line."""
    alone = graph_ms(launch_alone(kind, args))
    floor = graph_ms(launch_alone(kind, args, live=False))
    return (f"{label}: launch alone {alone:.4f} ms, chain floor (every mask 0) {floor:.4f} ms, "
            f"a call inside a replayed CUDA graph of 20 [{card}]")


def kernels_line(label: str, kind: str, args, card: str) -> tuple[str, list | None]:
    """(line, names) of the device kernels one wrapper call runs."""
    names = device_kernels(lambda: SOLVES[kind][0](*args))
    kern = ("not measured (the profiler showed no device event)" if names is None else
            f"{len(names)} ({', '.join(sorted(set(n[:40] for n in names)))})")
    return f"{label}: device kernels per wrapper call {kern} [{card}]", names


def phase_cycles(calls: dict) -> dict:
    """{(site, live): cycles an iteration spends in each phase of PHASES},
    from the kernels built with -DVLOAM_GN_PHASES: thread 0 of CTA 0, summed
    over one launch's iterations and divided by their number."""
    flags = kernels.NVCC_FLAGS
    kernels.NVCC_FLAGS, kernels._lib = flags + ("-DVLOAM_GN_PHASES",), None
    out = {}
    try:
        lib = kernels.lib()
        for site, args in calls.items():
            kind = "vo" if site == "VO" else "lidar"
            read = getattr(lib, f"vloam_gn_{kind}_phases")
            read.argtypes = [ctypes.c_void_p]
            iters = args[3] if kind == "lidar" else args[6]
            for live in (True, False):
                launch_alone(kind, args, live)()
                torch.cuda.synchronize()
                buf = (ctypes.c_longlong * len(PHASES["lidar"]))()
                kernels.check(read(ctypes.addressof(buf)), f"vloam_gn_{kind}_phases")
                out[(site, live)] = [v / iters for v in buf[:len(PHASES[kind])]]
    finally:
        kernels.NVCC_FLAGS, kernels._lib = flags, None
    return out


def _eps_dist(got, want) -> tuple[float, float]:
    """(translation, quaternion) gap of two poses, in float32 epsilons of
    want's largest translation component and in epsilons."""
    got, want = got.double(), want.double()
    sign = 1.0 if float(torch.dot(got[:4], want[:4])) >= 0 else -1.0
    eps = torch.finfo(torch.float32).eps
    return (float((got[4:] - want[4:]).abs().max()) / (eps * float(want[4:].abs().max())),
            float((got[:4] * sign - want[:4]).abs().max()) / eps)


def _perturbed(kind, args, gen, edges_only=False):
    """A copy of a solve's arguments with pose0 moved by up to 1 mrad and
    1 cm and each live row kept with probability 0.7 (for lidar with
    ``edges_only``, no planes)."""
    dev = args[0].device
    rnd = lambda *shape: torch.rand(*shape, generator=gen).to(dev)  # noqa: E731
    pose = pose_plus(args[0], torch.cat([(rnd(3) * 2 - 1) * 1e-3, (rnd(3) * 2 - 1) * 1e-2]))
    if kind == "lidar":
        _, (ep, ea, eb, ev), (pp, pn, pd, pv), *rest = args
        edge = (ep, ea, eb, ev & (rnd(ev.shape[0]) < 0.7))
        plane = (pp, pn, pd, pv & (rnd(pv.shape[0]) < 0.7))
        if edges_only:
            plane = tuple(x[:0] for x in plane)
        return (pose, edge, plane, *rest)
    _, X0, xb0, xb1, hd, nd, *rest = args
    keep = rnd(hd.shape[0]) < 0.7
    return (pose, X0, xb0, xb1, hd & keep, nd & keep, *rest)


def _float64(args):
    return tuple(_float64(a) if isinstance(a, tuple) else
                 a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args)


def spread(calls: dict, n: int) -> dict:
    """{problem: {pair: [(translation, quaternion) gap, ...]}} over n
    perturbed copies of each captured solve (``_perturbed``), the gaps in
    ``_eps_dist``'s units between the kernel (k), the plain version (p32)
    and the plain version in float64 (p64)."""
    gen = torch.Generator().manual_seed(0)
    out = {}
    for label, site, edges_only in (("MO edges only", "MO", True), ("MO", "MO", False),
                                    ("LO edges only", "LO", True), ("LO", "LO", False),
                                    ("VO", "VO", False)):
        kind = "vo" if site == "VO" else "lidar"
        kernel, plain = SOLVES[kind]
        gaps = out[label] = {"k-p32": [], "k-p64": [], "p32-p64": []}
        for _ in range(n):
            args = _perturbed(kind, calls[site], gen, edges_only)
            k, p32, p64 = kernel(*args), plain(*args), plain(*_float64(args))
            gaps["k-p32"].append(_eps_dist(k, p32))
            gaps["k-p64"].append(_eps_dist(k, p64))
            gaps["p32-p64"].append(_eps_dist(p32, p64))
    return out


def frame_calls(device, frame: int) -> dict:
    """Drive ``vloam_step`` over frames 0..frame of the synthetic course at
    ``kitti_hdl64``: {"LO" | "MO" | "VO": args of the site's first solve on
    the last frame}."""
    from unittest import mock

    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.data import stream
    from vloam_tpu_torch.models import frame_graph, laser_mapping, lidar_odometry, visual_odometry
    from vloam_tpu_torch.models.vloam import frame_to_device, init_vloam_state, vloam_step

    cfg = kitti_hdl64()
    ext = frame_graph.kitti_default_extrinsics(device)
    frames, _ = stream.gen_frames(cfg, ext, frame + 1, speed=0.8, yaw_rate=0.005)
    calls, now = {}, [0]

    def recorder(site, fn):
        def record(*args):
            if now[0] == frame:
                calls.setdefault(site, args)
            return fn(*args)
        return record

    state = init_vloam_state(cfg, device)
    with mock.patch.object(lidar_odometry, "solve_pose_gn_lidar",
                           recorder("LO", fused_gn.solve_pose_gn_lidar)), \
            mock.patch.object(laser_mapping, "solve_pose_gn_lidar",
                              recorder("MO", fused_gn.solve_pose_gn_lidar)), \
            mock.patch.object(visual_odometry, "solve_pose_gn_vo",
                              recorder("VO", fused_gn.solve_pose_gn_vo)):
        for i, f in enumerate(frames):
            now[0] = i
            img, g, m, bk, lf = frame_to_device(*f, device)
            state, _ = vloam_step(state, img, g, m, ext, cfg, pre_gridded=True, pre_buckets=bk,
                                  pre_lf_table=lf)
    return calls


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("gn_check: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    frame = int(argv[argv.index("--frame") + 1]) if "--frame" in argv else 15
    if "--src" in argv:
        kernels.SRC_DIR = Path(argv[argv.index("--src") + 1]).resolve()
    card = card_line()
    calls = frame_calls(torch.device("cuda", 0), frame)
    if "--spread" in argv:
        at = argv.index("--spread") + 1
        n = int(argv[at]) if at < len(argv) and argv[at].isdigit() else 20
        print(f"kernels from {kernels.SRC_DIR}; gaps over {n} perturbed copies of frame {frame}'s "
              f"solves, translation in float32 eps of |t|, quaternion in eps (median / max):")
        for label, gaps in spread(calls, n).items():
            t_max = float(calls[label[:2]][0][4:].abs().max())
            for pair, v in gaps.items():
                ts, qs = sorted(x[0] for x in v), sorted(x[1] for x in v)
                print(f"  {label} (|t| {t_max:.2f} m) {pair}: translation {ts[n // 2]:.2f} / "
                      f"{ts[-1]:.2f}, quaternion {qs[n // 2]:.2f} / {qs[-1]:.2f}")
        print(card)
        return 0
    rc = 0
    for site, args in calls.items():
        kind = "vo" if site == "VO" else "lidar"
        try:
            check(f"frame {frame} {site}", kind, args)
        except AssertionError as e:  # still time it
            print(f"gn_{kind} frame {frame} {site}: DIFFERS from the plain version: {e}")
            rc = 1
        wrapper = lambda: SOLVES[kind][0](*args)  # noqa: E731
        print(f"gn_{kind} frame {frame} {site}: wrapper {time_ms(wrapper):.4f} ms (median of 20), "
              f"graph {graph_ms(wrapper):.4f} ms a call [{card}]")
        print(launch_line(f"gn_{kind} frame {frame} {site}", kind, args, card))
    for label, kind, args, pose in cases(calls["MO"], calls["VO"]):
        try:
            check(label, kind, args, pose)
        except AssertionError as e:
            print(f"gn_{kind} {label}: DIFFERS: {e}")
            rc = 1
    if "--phases" in argv:
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                                "--format=csv,noheader"], capture_output=True, text=True).stdout
        for (site, live), cyc in phase_cycles(calls).items():
            kind = "vo" if site == "VO" else "lidar"
            masks = "masks as given" if live else "every mask 0"
            print(f"gn_{kind} frame {frame} {site}, {masks}: cycles an iteration, thread 0 of "
                  f"CTA 0: " + ", ".join(
                      f"{name} {c:.0f}" for name, c in zip(PHASES[kind], cyc))
                  + f"; total {sum(cyc):.0f} (SM clock now, max: {clock.strip()}) [{card}]")
    for site, args in calls.items():
        kind = "vo" if site == "VO" else "lidar"
        print(kernels_line(f"gn_{kind} frame {frame} {site}", kind, args, card)[0])
    print(card)
    return rc


if __name__ == "__main__":
    sys.exit(main())
