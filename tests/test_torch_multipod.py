"""The multi-pod tools: `launch.collectives` (the reference's
`hlo_analysis.analyze_collectives`) and `launch.dryrun --multipod` (rank
0's program on the (2, 16, 16) mesh over a `fake` process group), on
the CPU:

  * for each op kind and group the counter records from DTensor
    redistributions and the Uno ring's sends on a (2, 2, 2) fake mesh,
    its bytes equal `analyze_collectives` fed an HLO line written for the
    same collective (op, dtype, result shape, replica groups), and its
    DCI flag the reference's for groups inside and across pods;
  * the roofline's collective term: NVLink's rate within a host, the
    network's for the bytes that leave it;
  * `dryrun --multipod` on a reduced train cell (baseline and Uno, K3-K5
    counted on rank 0's blocks, DCI bytes) and on smollm-135m x
    decode_32k at (2, 16, 16): the reference's record keys, `multi_pod`,
    `chips` 512 and `collectives`.

Each test that builds a fake mesh takes it down before it returns."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import collectives as TC  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

NAMES = ("pod", "data", "model")
_HLO_DT = {"float32": "f32", "bfloat16": "bf16", "int8": "s8",
           "int32": "s32"}


@pytest.fixture
def fake_mesh():
    mesh = TM.make_fake_mesh((2, 2, 2), NAMES)
    try:
        yield mesh
    finally:
        TM.destroy_fake_mesh()


def hlo_line(ev) -> str:
    """The HLO instruction of one recorded collective."""
    ty = f"{_HLO_DT[ev['dtype']]}[{','.join(map(str, ev['shape']))}]"
    groups = "{{" + ",".join(map(str, ev["group"])) + "}}"
    if ev["op"] == "collective-permute":
        a, b = ev["group"]
        return (f"  %cp = {ty}{{0}} collective-permute({ty} %x), "
                f"source_target_pairs={{{{{a},{b}}}}}")
    return (f"  %c = {ty}{{0}} {ev['op']}({ty} %x), "
            f"replica_groups={groups}")


def _events(mesh):
    """Collectives of DTensor redistributions on every mesh axis, the
    baseline's pod all-reduce and a ring hop between the pods."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch import sharding
    dm = mesh.device_mesh
    x = sharding.wrap_block(torch.ones(4, 8), sharding.NamedSharding(
        mesh, ("model",)), (8, 8))
    with TC.CollectiveCounter(pod_size=4) as cc:
        x.redistribute(dm, [Replicate()] * 3)                 # all-gather
        p = torch.distributed.tensor.DTensor.from_local(
            torch.ones(8, 8), dm, [Partial(), Replicate(), Partial()])
        p.redistribute(dm, [Replicate(), Replicate(), Replicate()])
        p.redistribute(dm, [Shard(0), Replicate(), Shard(1)])
        dist.all_reduce(torch.ones(16), group=mesh.axis_group("pod"))
        sharding.ring_shift([torch.ones(3, dtype=torch.bfloat16)],
                            mesh.axis_group("pod"))
    return cc.events, TC.summarize(cc.events)


def test_collective_bytes_equal_the_reference_formula(fake_mesh):
    events, summary = _events(fake_mesh)
    ops = {ev["op"] for ev in events}
    assert ops == {"all-gather", "all-reduce", "reduce-scatter",
                   "collective-permute"}, ops
    assert any(ev["dci"] for ev in events)
    assert any(not ev["dci"] for ev in events)
    for ev in events:
        ref = hlo_analysis.analyze_collectives(hlo_line(ev), pod_size=4)
        assert ref["count"] == 1, hlo_line(ev)
        assert ref["total_bytes"] == ev["bytes"], (hlo_line(ev), ev)
        assert ref["dci_bytes"] == (ev["bytes"] if ev["dci"] else 0.0), ev
    whole = hlo_analysis.analyze_collectives(
        "\n".join(hlo_line(ev) for ev in events), pod_size=4)
    for k in ("total_bytes", "by_op", "dci_bytes", "count"):
        assert summary[k] == whole[k], k


def test_pod_groups_cross_the_dci():
    """Ranks pod-major: a group spans the DCI when it holds ranks of two
    pods, a send when its peer is in the other pod."""
    cc = TC.CollectiveCounter(pod_size=256)
    assert cc._pods(list(range(256))) == 1
    assert cc._pods([0, 256]) == 2
    assert not cc._off_host(list(range(8)))
    assert cc._off_host(list(range(16)))


def test_roofline_prices_off_host_bytes_at_the_network_rate():
    chip = roofline.H100_SXM
    r = roofline.roofline_terms(0.0, 0.0, 3e9, 512, off_host_bytes=1e9)
    assert r["t_collective_s"] == 2e9 / chip["ici_bw"] + 1e9 / chip["net_bw"]
    assert r["dominant"] == "collective"
    assert roofline.roofline_terms(1.0, 1.0, 4e9, 1) == \
        roofline.roofline_terms(1.0, 1.0, 4e9, 1, off_host_bytes=0.0)


def _reduced(monkeypatch):
    real = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.replace(
        TB.reduced(real(a)), name=a, n_layers=2))


@pytest.mark.parametrize("uno", (False, True))
def test_multipod_train_cell_reduced(monkeypatch, tmp_path, uno):
    _reduced(monkeypatch)
    argv = ["--arch", "granite-8b", "--shape", "train_4k", "--multipod",
            "--out", str(tmp_path)] + (["--uno"] if uno else [])
    assert dryrun.main(argv) == 0
    tag = "multipod-uno" if uno else "multipod"
    rec = json.loads((tmp_path / f"granite-8b__train_4k__{tag}.json")
                     .read_text())
    assert rec["multi_pod"] is True and rec["chips"] == 512
    assert rec["uno"] is uno and not rec["skipped"]
    coll = rec["collectives"]
    assert set(coll) >= {"total_bytes", "by_op", "dci_bytes", "count"}
    assert coll["count"] > 0 and coll["dci_bytes"] > 0
    assert rec["costs"]["collective_bytes"] == coll["total_bytes"]
    assert rec["costs"]["dci_bytes"] == coll["dci_bytes"]
    launches = rec["costs"]["kernel_launches"]
    if uno:
        assert coll["by_op"].get("collective-permute", 0) > 0
        assert set(launches) == {"gf_matmul/encode", "gf_matmul/decode",
                                 "quant_int8", "dequant_int8/acc"}
    else:
        assert not launches and "collective-permute" not in coll["by_op"]
    r = rec["roofline"]
    assert r["t_collective_s"] > 0
    from repro_torch.launch import roofline_report
    text = roofline_report.report(tmp_path)
    assert "### multi-pod, rank 0 of (2, 16, 16)" in text
    assert "| granite-8b | train_4k" in text
    assert "multipod cells costed: 1" in text


def test_multipod_smollm_decode_record(tmp_path):
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                        "--multipod", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "smollm-135m__decode_32k__multipod.json")
                     .read_text())
    one = dryrun.cost_cell("smollm-135m", "decode_32k")
    assert set(rec) == set(one) | {"collectives"}
    assert rec["multi_pod"] is True and rec["chips"] == 512
    assert rec["param_count"] == one["param_count"]
    # 128 sequences of 32k split 32 ways over pod x data: rank 0 holds 4
    # rows of every layer's cache, not the card's 128
    assert rec["argument_size_in_bytes"] < one["argument_size_in_bytes"] / 16
    assert rec["collectives"]["count"] == rec["costs"]["collective_sites"]
