#!/usr/bin/env python3
"""Time K3, the UnoRC GF(2^8) product (`unorc_cuda.gf_matmul`: RS(8, 2)
encode and decode), of one checkout at the shapes the UnoRC sync gives
it, and report what the compiler made of it, so that two checkouts can
be compared on one card.

    python3 tools/gf_ab.py --tree PATH --label NAME

PATH is the root of a checkout (its ``src/`` is imported; default: this
one).  Run it once per checkout on one card, in turns (parent, change,
change, parent): it prints one JSON line per use and one for the build,
and writes them to chiprun_out/gf_ab_<label>.json.

Uses: encode (the RS(8, 2) generator rows) and decode (rows {0, 1}
rebuilt from the survivors) at one p = 2 chunk of smollm-135m's
gradient, (2, 8, 2,102,016) bytes, and at one part of a p = 4 ring
chunk, (4, 8, 525,504).  Each use carries the median device time of 25
wrapper calls behind a sleep kernel (CUDA events) with the L2 warm as
the sync finds it (`ms`) and with the L2 flushed before each call
(`ms_cold`), the device kernels and device µs per call from a
`torch.profiler` trace of 20 calls, the byte bound at 3.35 TB/s, and
whether the result is bitwise equal to the plain version.

The build line compiles the checkout's `unorc_kernels.cu` once more to
a cubin with `-Xptxas -v` and reads it back with `cuobjdump -sass`: for
every K3 instantiation its registers, stack and spills, and for the one
the path runs (M = 2; K = 8 where K is a template parameter) its SASS
instruction count, by opcode, in all and inside its largest loop (the
body between a backward branch and its target), whose SASS goes to
chiprun_out/gf_ab_<label>.sass.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile

UNO_ARCH = "smollm-135m"
HBM_BYTES_PER_S = 3.35e12
PODS = (2, 4)


def time_ms(fn, n: int = 25, flush=None) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def call_profile(fn, n: int = 20) -> dict:
    """Device kernels and device µs per call from a profiler trace of n
    calls between two sleep kernels (not counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        for _ in range(n):
            fn()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.name]
    return dict(device_kernels_per_call=len(kernels) / n,
                device_us_per_call=sum(e.time_range.elapsed_us()
                                       for e in kernels) / n)


def shapes() -> dict:
    """{p: (groups, 8, width)} of K3's input at each pod count: one
    chunk at p = 2, one ring part of a chunk at p = 4."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import params as P
    run = RunConfig()
    n_params = P.param_count(P.param_defs(get_config(UNO_ARCH)))
    unit = run.uno_chunks * run.uno_ec_data * 256
    c = -(-n_params // unit) * unit // run.uno_chunks
    out = {}
    for p in PODS:
        part = c if p == 2 else -(-c // p)
        out[p] = (p, run.uno_ec_data, -(-part // 256) * 256 // run.uno_ec_data)
    return out


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA(?:\.\S+)?\s+(?:\S+,\s*)?0x([0-9a-f]+)")


def _ptxas(report: str) -> dict:
    """{kernel: {registers, stack, spill_stores, spill_loads}} of the K3
    instantiations in nvcc's -Xptxas -v report."""
    out, cur = {}, None
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = m.group(1) if "gf_matmul" in m.group(1) else None
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = _PROPS.search(line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def _sass(dump: str, name: str) -> dict:
    """Instruction counts of function `name` in a cuobjdump -sass dump:
    in all and inside its largest loop, each by opcode (predicates and
    modifiers dropped)."""
    insns, on = [], False
    for line in dump.splitlines():
        if "Function :" in line:
            on = line.split("Function :")[1].strip() == name
            continue
        m = _INSN.match(line) if on else None
        if m:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
            insns.append((int(m.group(1), 16), text))
    body = []
    for i, (addr, text) in enumerate(insns):
        b = _BRA.search(text)
        if b and int(b.group(1), 16) < addr:
            start = int(b.group(1), 16)
            loop = [t for a, t in insns[:i + 1] if a >= start]
            body = loop if len(loop) > len(body) else body
    ops = [t for _, t in insns if not t.startswith("NOP")]

    def hist(texts):
        return dict(collections.Counter(t.split()[0].split(".")[0]
                                        for t in texts).most_common())
    return dict(instructions=len(ops), by_opcode=hist(ops),
                loop_instructions=len(body), loop_by_opcode=hist(body))


def build_report(tree: pathlib.Path):
    """(ptxas figures of every K3 instantiation and SASS counts of the one
    the path runs, that one's SASS), from a fresh cubin of the tree's
    unorc_kernels.cu."""
    from repro_torch.kernels import build
    src = tree / "src" / "repro_torch" / "kernels" / "csrc" / \
        "unorc_kernels.cu"
    nvcc = build.nvcc_path()
    with tempfile.TemporaryDirectory() as tmp:
        cubin = pathlib.Path(tmp) / "unorc.cubin"
        rep = subprocess.run(
            [nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xptxas", "-v", "-o", str(cubin),
             str(src)], capture_output=True, text=True, check=True)
        dump = subprocess.run(
            [str(pathlib.Path(nvcc).parent / "cuobjdump"), "-sass",
             str(cubin)], capture_output=True, text=True, check=True).stdout
    ptxas = _ptxas(rep.stdout + rep.stderr)
    # the path's instantiation: M = 2, and K = 8 where K is a parameter
    path = [n for n in ptxas if re.search(r"gf_matmul_kernelILi2E(Li8E)?E",
                                          n)]
    text = dump.split(f"Function : {path[0]}")[1].split("Function :")[0] \
        if path else ""
    return dict(ptxas=ptxas, path_kernel=path[0] if path else None,
                sass=_sass(dump, path[0]) if path else None), text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).parents[1]))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gf_ab: no CUDA device", file=sys.stderr)
        return 2
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import gf, ref
    from repro_torch.kernels import unorc_cuda as U
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []

    def emit(**row):
        rows.append(dict(label=args.label, **row))
        print(json.dumps(rows[-1]), flush=True)

    enc = gf.rs_generator_rows(8, 2)
    dec = gf.rs_decode_matrix(8, 2, (0, 1), (0, 1))
    for p, shape in shapes().items():
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=g)
        for use, coeffs in (("encode", enc), ("decode", dec)):
            def call():
                return U.gf_matmul(x, coeffs, use=use)
            n_bytes = shape[0] * (shape[1] + len(coeffs)) * shape[2]
            emit(name=f"gf_matmul/{use}@p{p}", shape=list(shape),
                 bytes=n_bytes, bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                 bitwise_equal=torch.equal(call(),
                                           ref.gf_matmul_ref(coeffs, x)),
                 ms=time_ms(call),
                 ms_cold=time_ms(call, flush=flush_buf.zero_),
                 **call_profile(call))
        del x
    report, dump = build_report(tree)
    emit(name="build", **report)
    out = pathlib.Path("chiprun_out") / f"gf_ab_{args.label}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    out.with_suffix(".sass").write_text(dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
