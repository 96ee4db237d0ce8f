"""The refill kernel's unit size measured on one CUDA GPU, and the bounds of
both kernels.

    python -m altair_tpu_torch.profile_refill [--lanes 64 128 256]
        [--sizes N ...] [--rounds R] [--out FILE]

Builds ``csrc/refill.cu`` once for each number of lanes a unit (``U``,
``-DALTAIR_REFILL_LANES``), one nvcc each, all at once, with the flags of
``core/_build.py``.  At each size (default 4,194,304, 2^20, 1,600,000 and
1,600,512 rays) it times every build whose unit (``U * budget`` rays)
divides it at the simulate engine's main-trace shape
(production scene without the rim, Lambertian, philox, 4096 cap, budget
``_REFILL_BUDGET``) with the handoff at ``_REFILL_HANDOFF`` (``thresh =
int(_REFILL_HANDOFF * U * budget)``, as the dispatch computes it) and
without it, in turns (builds forward, then backward, ``--rounds`` times),
CUDA events, mean of 5 launches after a warm one; each build's slots
without the handoff, put in lane order, must equal the first build's bit
for bit (a lane's slots do not depend on the schedule).  Then:

* the per-step instruction mix of the refill and bounce kernels
  (Lambertian, philox), counted by pipe from ``cuobjdump -sass`` of the
  built libraries (``sass_step_mix``);
* the bounce kernel's per-bounce latency: one thread, no port, no
  absorption, 4096 bounces against 1 (``bounce_step_latency_ms``).

Prints one JSON line per measurement; ``--out`` also writes them to a
file.  Each line carries the card's name, power limit and maximum SM
clock from ``nvidia-smi``.

``sass_step_mix``, ``traced_steps``, ``ops_bound_ms``, ``pipe_ms`` and
``bounce_step_latency_ms`` are what ``chip_smoke.py`` computes the
kernels' ``bound_ms`` with.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

MAX_BOUNCES = 4096
# the main trace, 2^20, and the retrace chunk's 1.6M rays as a whole
# number of 512-lane units (U = 256 cannot take 1,600,000 at budget 4)
SIZES = (4_194_304, 1 << 20, 1_600_000, 1_600_512)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA's data sheet)

# Thread instructions each SM starts per clock, by pipe (CUDA C++
# Programming Guide, arithmetic throughput for compute capability 9.0; the
# issue rate is one warp instruction per scheduler per clock, 4 a SM).
# FP32 add, multiply and FMA use both FMA pipes (128 a clock); IMAD only
# the heavy one (64); the ALU pipe (integer add, logic, shifts, compares,
# min/max, selects) 64; MUFU and conversions 16.
SLOTS_PER_CLK = 128
RATES = {"fp32": 128, "imad": 64, "alu": 64, "xu": 16}

_FP32 = {"FADD", "FMUL", "FFMA"}
_IMAD = {"IMAD", "IMUL", "VIADD", "VIADDMNMX"}
_ALU = {"IADD3", "LOP3", "SHF", "ISETP", "FSETP", "FMNMX", "IMNMX", "SEL",
        "FSEL", "LEA", "PRMT", "PLOP3", "P2R", "R2P", "IABS", "FCHK", "LOP",
        "IADD", "SHL", "SHR", "BMSK", "ISCADD"}
_XU = {"MUFU", "I2F", "I2FP", "F2I", "F2F", "I2I", "FRND", "FLO", "BREV"}
# the warp's vote and lane count: the refill kernel's pool code
_WARP = {"VOTE", "POPC", "MATCH"}

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
_TARGET = re.compile(r"(0x[0-9a-f]+)\s*$")     # cuobjdump: BRA 0x440


def emit(obj, fh=None) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if fh is not None:
        fh.write(line + "\n")
        fh.flush()


def card() -> dict:
    """The card's name, power limit and maximum SM clock (nvidia-smi),
    and its SM count (torch)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, power, clock = (s.strip() for s in out.split(","))
    return {"name": name, "power_limit_w": float(power),
            "max_sm_clock_mhz": float(clock),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count}


def _cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(path):
        raise RuntimeError("cuobjdump not found on PATH or at "
                           "/usr/local/cuda/bin")
    return path


def _pipe(op: str, full: str) -> str:
    """The pipe of an instruction (``op`` its mnemonic, ``full`` with its
    modifiers), or what it is when it is no arithmetic: ``move`` (a
    register copy, also on the IMAD pipe), ``warp`` (vote, lane count),
    ``uniform``, ``memory`` or ``control``."""
    if op == "MOV" or full.startswith("IMAD.MOV"):
        return "move"
    if op.startswith("U"):
        return "uniform"          # the warp-uniform datapath
    if op in _FP32:
        return "fp32"
    if op in _IMAD:
        return "imad"
    if op in _ALU:
        return "alu"
    if op in _XU:
        return "xu"
    if op in _WARP:
        return "warp"
    if op in ("LDG", "STG", "LD", "ST", "LDL", "STL", "LDS", "STS", "LDC",
              "ATOM", "ATOMG", "RED", "SHFL", "REDUX"):
        return "memory"
    return "control"


def sass_step_mix(lib: Path, kernel: str) -> dict:
    """The per-step instruction mix of ``kernel`` (a substring of the
    mangled name, such as ``refill_kernelILi0ELb0E``: the Lambertian,
    philox instantiation) in the shared library ``lib``, from ``cuobjdump
    -sass``.

    The step loop is the innermost backward branch whose range holds the
    Philox rounds (at least 20 wide 32-bit multiplies); its instructions
    are counted by pipe (``_pipe``), leaving out the code around each
    loop nested in it (the trig functions' slow argument reduction, which
    the fast path jumps over: the smallest forward branch around the
    loop) and a finished ray's code (its box flight and slot stores: the
    smallest forward branch around the global stores), which runs once a
    ray, not once a step.  The rest counts once a step, though a step
    skips some of it (the scatter on an exit, a lane's take on most
    steps).
    A loop the compiler unrolled ``f`` times holds ``f`` steps; ``f`` is
    its wide multiplies over 20."""
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return step_mix_of_sass(text, kernel)


def step_mix_of_sass(text: str, kernel: str) -> dict:
    """``sass_step_mix`` on the text ``cuobjdump -sass`` printed."""
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs[1:] if kernel in f.split("\n", 1)[0]),
                None)
    if body is None:
        raise RuntimeError(f"no function matching {kernel} in the SASS")
    name = body.split("\n", 1)[0].strip()
    instrs = [(int(m.group(1), 16), m.group(2), m.group(2) + m.group(3),
               m.group(4)) for m in map(_INSTR.search, body.splitlines())
              if m]
    loops, skips = [], []
    for addr, op, _, args in instrs:
        t = _TARGET.search(args.strip())
        if op != "BRA" or not t:
            continue
        to = int(t.group(1), 16)
        (loops if to <= addr else skips).append((min(to, addr),
                                                 max(to, addr)))

    def wide(lo, hi):
        return sum(1 for a, op, full, _ in instrs if lo <= a <= hi
                   and full.startswith(("IMAD.WIDE.U32", "IMAD.HI.U32")))

    step = min((lp for lp in loops if wide(*lp) >= 20),
               key=lambda lp: lp[1] - lp[0], default=None)
    if step is None:
        raise RuntimeError(f"no step loop with Philox rounds in {name}")
    lo, hi = step
    nested = [lp for lp in loops if lo <= lp[0] and lp[1] <= hi
              and lp != step]
    # each nested loop is the slow path of a library function, jumped
    # over on the fast path: leave out the smallest forward skip around it
    cold = [min((sk for sk in skips if sk[0] < a and b < sk[1]),
                key=lambda sk: sk[1] - sk[0], default=(a, b + 1))
            for a, b in nested]
    # a finished ray's code (its box flight and slot stores) runs once a
    # ray, not once a step: the smallest forward skip around the stores
    stores = [a for a, op, _, _ in instrs if op == "STG" and lo <= a <= hi]
    done = (min((sk for sk in skips if sk[0] < min(stores)
                 and max(stores) < sk[1] and lo <= sk[0]),
                key=lambda sk: sk[1] - sk[0], default=(lo, lo))
            if stores else (lo, lo))
    counts, per_ray = {}, 0
    for a, op, full, _ in instrs:
        if not lo <= a <= hi or any(x < a < y for x, y in cold):
            continue
        if done[0] < a < done[1]:
            per_ray += 1
            continue
        p = _pipe(op, full)
        counts[p] = counts.get(p, 0) + 1
    unroll = max(1, round(wide(lo, hi) / 20))
    per_step = {p: c / unroll for p, c in sorted(counts.items())}
    return {"function": name, "loop": [hex(lo), hex(hi)], "unroll": unroll,
            "slow_paths_left_out": [[hex(x), hex(y)] for x, y in cold],
            "per_step": per_step,
            "per_step_total": sum(per_step.values()),
            "finished_ray_code": [hex(done[0]), hex(done[1])],
            "per_finished_ray": per_ray / unroll}


def pipe_ms(mix: dict, steps: int, crd: dict) -> dict:
    """The time ``steps`` steps of the instruction mix ``mix`` (from
    ``sass_step_mix``) keep each arithmetic pipe busy on the card ``crd``
    (``card()``), over all SMs at the maximum SM clock (FP32 and IMAD
    share the FMA pipes: ``fp32+imad``), and ``issue``: every instruction
    of the step on the issue slots, its control, moves, uniform and warp
    code included (the loop's own floor, overhead and all)."""
    ps = mix["per_step"]
    per_sm_clk = {
        "fp32+imad": (ps.get("fp32", 0) + ps.get("imad", 0)) / RATES["fp32"],
        "imad": ps.get("imad", 0) / RATES["imad"],
        "alu": ps.get("alu", 0) / RATES["alu"],
        "xu": ps.get("xu", 0) / RATES["xu"],
        "issue": sum(ps.values()) / SLOTS_PER_CLK,
    }
    clk = crd["max_sm_clock_mhz"] * 1e6
    return {p: c * steps / (crd["sms"] * clk) * 1e3
            for p, c in per_sm_clk.items()}


def ops_bound_ms(mix: dict, steps: int, crd: dict) -> tuple[float, str]:
    """The least time ``steps`` steps of ``mix``'s arithmetic (``RATES``'
    pipes: FP32, IMAD, ALU and MUFU/conversions; not the control,
    moves, uniform or warp-vote code) take on the card ``crd``: its
    slowest pipe.  Returns ``(ms, pipe)``."""
    times = pipe_ms(mix, steps, crd)
    times.pop("issue")
    pipe = max(times, key=times.get)
    return times[pipe], pipe


def bytes_bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def traced_steps(res, live=None) -> int:
    """The bounce steps a kernel ran for ``res`` (and the refill kernel's
    ``live`` state): a finished ray took its bounces plus one step for an
    exit (the exit step adds no bounce); a ray in flight at the handoff
    its bounces so far."""
    done = res.status != 0
    steps = int((res.n_bounces.long() + (res.status == 1).long())[done]
                .sum())
    if live is not None:
        budget = int(res.status.shape[0] // live.ray_idx.shape[0])
        flight = live.ray_idx < budget
        steps += int(live.bounces.long()[flight].sum())
    return steps


def bounce_step_latency_ms(device, reps: int = 5) -> float:
    """One thread of the bounce kernel with the port closed (cos_cap
    below the sphere) and a wall that absorbs nothing: its time for 4096
    bounces less its time for 1, over 4095 (CUDA events)."""
    from . import SCENE_OPTIMIZE, SOURCE_OVERNIGHT
    from .core import trace_cuda

    sv, srcv = trace_cuda.kernel_operands(SCENE_OPTIMIZE, SOURCE_OVERNIGHT,
                                          device)
    sv[1] = -2.0 * sv[0]
    sv[2] = 1.0
    times = {}
    for mb in (1, MAX_BOUNCES):
        times[mb] = _events_ms(lambda: trace_cuda.bounce(
            (1, 2), sv, srcv, 1, 0, mb), reps)
    return (times[MAX_BOUNCES] - times[1]) / (MAX_BOUNCES - 1)


def _events_ms(fn, reps: int = 5) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# Builds of refill.cu side by side
# ---------------------------------------------------------------------------

def build_variants(variants: dict) -> dict:
    """Build each ``{name: defines}`` of ``csrc/refill.cu`` into ``build/``
    with the flags of ``core/_build.py``: one nvcc each, all at once.
    Returns ``{name: (library, ptxas lines)}``."""
    from .core import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, defines in variants.items():
        lib = _build.BUILD_DIR / f"libprofile_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               *(f"-D{d}" for d in defines), "-o", str(lib),
               str(_build.CSRC / "refill.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        o, e = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{e}")
        out[name] = (lib, [ln.strip() for ln in (o + e).splitlines()
                           if "registers" in ln or "spill" in ln])
    return out


def _bind(lib: Path):
    dll = ctypes.CDLL(str(lib))
    fn = dll.altair_refill
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                    ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 20)
    fn.restype = ctypes.c_int
    return dll.altair_refill_lanes(), fn


class _Launch:
    """Output planes for n rays and a launcher of any build's
    ``altair_refill`` into them (Lambertian, philox, seed (7, 8))."""

    def __init__(self, device, sv, srcv, n: int, budget: int):
        self.sv, self.srcv, self.n, self.budget = sv, srcv, n, budget
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.out = ([torch.empty(n, **i32)] + [torch.empty(n, **f32)
                                               for _ in range(9)]
                    + [torch.empty(n, **i32)])
        m = n // budget
        self.live = ([torch.empty(m, **f32) for _ in range(6)]
                     + [torch.empty(m, **i32), torch.empty(m, **i32)])

    def __call__(self, fn, thresh: int) -> None:
        err = fn(self.sv.data_ptr(), self.srcv.data_ptr(), 7, 8, MAX_BOUNCES,
                 0, 0, self.n, self.budget, thresh,
                 *[o.data_ptr() for o in self.out],
                 *[t.data_ptr() for t in self.live],
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"refill launch failed: CUDA error {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_refill: needs a CUDA device", file=sys.stderr)
        return 2
    from . import SCENE_OPTIMIZE, SOURCE_OVERNIGHT
    from .core import _build, trace_cuda

    device = torch.device("cuda", 0)
    fh = open(args.out, "w") if args.out else None
    crd = card()
    emit({"card": crd, "torch": torch.__version__,
          "cuda": torch.version.cuda}, fh)
    built = build_variants({f"U{u}": (f"ALTAIR_REFILL_LANES={u}",)
                            for u in args.lanes})
    fns = {}
    for name, (lib, ptxas) in built.items():
        lanes, fn = _bind(lib)
        fns[name] = (lanes, fn)
        emit({"build": name, "lanes": lanes, "ptxas": ptxas}, fh)

    scene = SCENE_OPTIMIZE.with_(max_bounces=MAX_BOUNCES, exact_rim=False)
    sv, srcv = trace_cuda.kernel_operands(scene, SOURCE_OVERNIGHT, device)
    budget = trace_cuda._REFILL_BUDGET
    for n in args.sizes:
        names = [name for name in fns if n % (fns[name][0] * budget) == 0]
        launch = _Launch(device, sv, srcv, n, budget)
        ref = None
        for name in names:          # without the handoff: slots equal
            lanes, fn = fns[name]
            launch(fn, 0)
            torch.cuda.synchronize()
            # slot j of lane l of unit u at u*budget*U + j*U + l: in lane
            # order, whatever U
            got = [o.view(-1, budget, lanes).transpose(1, 2).reshape(-1)
                   for o in launch.out]
            if ref is None:
                ref = got
            if not all(torch.equal(a, b) for a, b in zip(ref, got)):
                raise RuntimeError(f"{name} at n={n}: slots differ from "
                                   f"{names[0]}'s without the handoff")
        times = {name: {"handoff_ms": [], "no_handoff_ms": []}
                 for name in names}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                lanes, fn = fns[name]
                thresh = int(trace_cuda._REFILL_HANDOFF * lanes * budget)
                times[name]["handoff_ms"].append(
                    _events_ms(lambda: launch(fn, thresh)))
                times[name]["no_handoff_ms"].append(
                    _events_ms(lambda: launch(fn, 0)))
        for name in names:
            emit({"n": n, "build": name, "lanes": fns[name][0],
                  "thresh": int(trace_cuda._REFILL_HANDOFF * fns[name][0]
                                * budget), **times[name],
                  "card": crd["name"], "power_limit_w": crd["power_limit_w"]},
                 fh)

    # the shipped builds' instruction mixes and the bounce kernel's chain
    _build.build(*trace_cuda.KERNELS)
    for name, kern in (("refill", "refill_kernelILi0ELb0E"),
                       ("bounce", "bounce_kernelILi0ELb0E")):
        emit({"sass": name, **sass_step_mix(_build.library_path(name),
                                            kern)}, fh)
    emit({"bounce_step_latency_ms": bounce_step_latency_ms(device),
          "card": crd["name"], "power_limit_w": crd["power_limit_w"]}, fh)
    if fh is not None:
        fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
