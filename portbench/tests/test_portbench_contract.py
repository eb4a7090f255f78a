"""The benchmark's files against its contract, on the CPU: names and units,
every cell's files found by name, what the harness imports, the
statistics and trace arithmetic on hand values, and a run without a card.

    python -m pytest portbench/tests -q
"""
import ast
import hashlib
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.drivers import common
from portbench.reference import model as ref_model

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield key, entry["name"]


@pytest.mark.parametrize("key,name", list(_names()))
def test_names_use_allowed_characters(key, name):
    assert NAME.match(name), (key, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source", "workloads"}
    if "bound" in metric:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200
    assert set(metric) <= keys
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]
    assert setup["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= len(BENCH["workloads"]) <= 24
    # a full check of 24 cells at this window fits the driver's budget
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_by_name(work):
    c = harness.cell(work["name"])
    assert work["chips"] in (1, 4) and len(work["why"]) <= 200
    assert (harness.PKG / "drivers" / f"{c['traffic']['driver']}.py"
            ).exists()
    assert work["traffic"] in c["config"]["limits"]
    e2e = harness.cell_metrics(BENCH, work["name"], "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = harness.cell_metrics(BENCH, work["name"], "per_layer")
    assert layer
    for m in layer:
        assert hasattr(harness.metric_reader(m["name"]), "read")


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = ROOT / conf["file"]
    assert path.parts[len(ROOT.parts)] == "portbench"
    data = json.loads(path.read_text())
    assert data["name"] == conf["name"]
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    assert (harness.PKG / "hostpath" / "configs"
            / data["program_config"]).exists()


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(harness.PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(harness.PKG)))
def test_no_jax_and_reference_plain(path):
    tops = set(_imports(path))
    assert not tops & {"jax", "jaxlib", "flax", "sessd_tpu"}, path
    if "reference" in path.relative_to(harness.PKG).parts:
        assert "sessd_torch" not in tops, path
        assert "portbench" not in tops, path


def test_percentile_over_all_samples():
    vals = [float(v) for v in range(1, 101)]
    assert harness.percentile(vals, 95) == pytest.approx(95.05)
    assert harness.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert harness.percentile([1.0, 2.0], 95) == pytest.approx(1.95)


def test_busy_union_and_gaps():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert harness.union_us(spans) == 4.0
    assert harness.idle_gaps(spans, (0.0, 10.0)) == [(6.0, 10.0),
                                                    (3.0, 5.0)]


def test_roofline_of_a_hand_made_rulebook():
    # three voxels in a row along x at batch 0: the centre tap hits all
    # three, the two x neighbours one pair each way: 7 hits
    coords = torch.tensor([[0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2]])
    taps = ref_model.subm_taps(coords, (1, 1, 1, 3))
    assert ref_model.conv_hits(taps) == 3 + 2 + 2
    conv = (16, 32, 7, 3, 3, 27)
    flops = 2 * 7 * 16 * 32
    nbytes = (3 * 16 + 3 * 32 + 27 * 16 * 32) * 2 + 3 * 27 * 2
    want = max(flops / 989e12, nbytes / 3.35e12)
    assert common.fwd_bound(conv, 2, 2, "bfloat16") == pytest.approx(want)
    assert harness.roofline(want, 2 * want) == pytest.approx(50.0)
    assert harness.roofline(want, 0.0) is None


def test_downsample_rulebook_by_hand():
    # one voxel at x = 2 under a (1, 1, 3) kernel, stride 2, padding 1 on x:
    # outputs o read i = 2 o - 1 + k, so x = 2 is read by o = 1 (k = 1)
    # and by o = 2 (k = -1: none) -> one output, one hit
    coords = torch.tensor([[0, 0, 0, 2]])
    out, shape, taps = ref_model.down_taps(coords, (1, 1, 1, 5), (1, 1, 3),
                                           (1, 1, 2), (0, 0, 1))
    assert shape == (1, 1, 1, 3)
    assert out.tolist() == [[0, 0, 0, 1]]
    assert ref_model.conv_hits(taps) == 1
    assert [int(o.numel()) for o, _ in taps] == [0, 1, 0]


def test_flops_count_hits_only():
    """The backbone's operations as FlopCounterMode counts them equal
    2 x hits x Cin x Cout summed over its 14 convs."""
    from torch.utils.flop_counter import FlopCounterMode

    net = ref_model.VoxelNet(sparse_shape=(41, 64, 64)).eval()
    coords = torch.tensor([[0, 20, 30, 30], [0, 20, 30, 31],
                           [0, 21, 30, 30], [0, 22, 31, 30]])
    chain = net.chain(coords, 1)
    convs = ref_model.sparse_conv_shapes(net, chain)
    assert len(convs) == 14
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        net.backbone(torch.rand(4, 4), chain, lambda x: x)
    assert counter.get_total_flops() == sum(2 * h * ci * co for ci, co, h,
                                            _, _, _ in convs)


def test_reference_matches_the_program_on_the_cpu():
    """The float32 reference and the port's float32 forward (its plain
    twins on the CPU) on one seeded scan and seeded weights."""
    from sessd_torch import builder

    from portbench.hostpath.ops.voxelize import voxelize_np
    from portbench.hostpath.utils.synth_scene import make_scene
    from portbench.reference.weights import make_state_dict

    cfg = builder.load_config("se_ssd_kitti_car.py")
    prog = builder.build_detector(cfg).eval()
    ref = ref_model.VoxelNet().eval()
    sd = make_state_dict(ref.state_dict(), 2147483713, "cpu")
    prog.load_state_dict(sd)
    ref.load_state_dict(sd)
    pts = make_scene(seed=5)[0]
    vox, coords, npts = voxelize_np(pts, builder.build_voxelizer(
        cfg.voxel_generator))
    vox, npts = torch.from_numpy(vox), torch.from_numpy(npts)
    c = torch.from_numpy(coords)
    with torch.no_grad():
        chain, _ = prog.device_inputs(c[None], torch.ones(1, len(c),
                                                          dtype=torch.bool), 1)
        want = prog(vox, npts, chain, 1)[0]
        bz = torch.cat([torch.zeros(len(c), 1, dtype=torch.long), c.long()],
                       1)
        got = ref(vox, npts, ref.chain(bz, 1))
    for k, r in got.items():
        gap = torch.linalg.vector_norm(want[k] - r) / torch.linalg.vector_norm(r)
        assert gap < 1e-4, (k, float(gap))


def test_run_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, "-m", "portbench.run",
                        "--workload", BENCH["workloads"][0]["name"],
                        "--seed", "2147483659", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


FROZEN = json.loads((harness.PKG / "FROZEN.json").read_text())


@pytest.mark.parametrize("entry", FROZEN["files"], ids=lambda e: e["path"])
def test_frozen_copies_hold_their_sha256(entry):
    data = (ROOT / entry["path"]).read_bytes()
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
