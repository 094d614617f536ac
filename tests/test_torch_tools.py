"""The port's dataset tools (fvp_torch/tools/) against the reference
package's (tools/), on the same synthesised trees: the pose library, the
image resize, the SPACE_CENTER checks and the camera plot give the same
files, numbers and points; the train supervisor relaunches a stalled
child with --resume and gives up after --max-restarts; and a tree from
fvp_torch/tools/fixtures.py loads to the same records in both packages'
Panoptic, Shelf and Campus datasets.

The reference's tools run as the repository ships them: each is loaded
from its file and its main() called with its command line."""

import contextlib
import importlib.util
import io
import os
import pickle
import signal
import sys
import textwrap

import numpy as np
import pytest
import torch

from fvp_torch.data.panoptic import TRAIN_LIST, VAL_LIST
from fvp_torch.tools import fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: parallel test workers then do not oversubscribe
    the cores (the previous count restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_tool(name):
    return importlib.import_module(f"fvp_torch.tools.{name}")


def _run_reference(name, argv, monkeypatch) -> str:
    """The reference tool's main() on `argv`; its standard output."""
    mod = _reference_tool(name)
    monkeypatch.setattr(sys, "argv", [f"tools/{name}.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def _run_port(name, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert _port_tool(name).main(argv) == 0
    return out.getvalue()


def _yaml(src, dst, **subs) -> str:
    """A copy of the config `src` with each `KEY: value` line of `subs`
    replaced."""
    lines = open(os.path.join(ROOT, src)).read().splitlines()
    for key, val in subs.items():
        hits = [i for i, s in enumerate(lines)
                if s.strip().startswith(f"{key}:")]
        assert len(hits) == 1, key
        indent = lines[hits[0]][:len(lines[hits[0]])
                                - len(lines[hits[0]].lstrip())]
        lines[hits[0]] = f"{indent}{key}: {val}"
    with open(dst, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(dst)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Panoptic training and validation sequences, a Shelf and a Campus
    tree, the COCO-17 pose library both configs read (written by the
    port's tool), and configs pointing at them."""
    root = tmp_path_factory.mktemp("trees")
    pan = root / "Panoptic"
    for i, seq in enumerate(TRAIN_LIST[:2]):
        fixtures.write_panoptic_sequence(str(pan), seq, n_frames=25,
                                         n_people=2 + i, seed=10 + i)
    for i, seq in enumerate(VAL_LIST):
        fixtures.write_panoptic_sequence(str(pan), seq, n_frames=13,
                                         n_people=1 + i % 3, seed=20 + i)
    shelf_gt = fixtures.write_shelf_tree(str(root / "Shelf"), "shelf", 5,
                                         (450.0, -320.0, 800.0), (1032, 776))
    fixtures.write_shelf_tree(str(root / "Campus"), "campus", 3,
                              (3000.0, 4500.0, 1000.0), (360, 288))
    _run_port("extract_training_poses",
              ["--data_dir", str(pan), "--out",
               str(root / "panoptic_training_pose.pkl"), "--coco17",
               "--interval", "3"])
    cfgs = {
        "panoptic": _yaml("configs/panoptic/jln64.yaml",
                          root / "panoptic.yaml", DATADIR=f'"{pan}"'),
        "shelf": _yaml("configs/shelf/jln64.yaml", root / "shelf.yaml",
                       DATADIR=f'"{root / "Shelf"}"', NUM_DATA=24),
        "campus": _yaml("configs/campus/jln64.yaml", root / "campus.yaml",
                        DATADIR=f'"{root / "Campus"}"', NUM_DATA=24),
    }
    return root, cfgs, shelf_gt


def _no_cache(cfg_path):
    """Drop the Panoptic meta cache, so that each package indexes the tree
    itself."""
    from fvp_torch.config import load_config

    data_dir = load_config(cfg_path).data_dir
    for name in ("train_meta_fvp.pkl", "validation_meta_fvp.pkl"):
        path = os.path.join(data_dir, name)
        if os.path.exists(path):
            os.remove(path)


@pytest.mark.parametrize("flags", [(), ("--coco17",),
                                   ("--interval", "3", "--max_poses", "7")],
                         ids=["panoptic15", "coco17", "interval_max"])
def test_extract_training_poses_matches_reference(trees, tmp_path, flags,
                                                  monkeypatch):
    root = trees[0]
    argv = ["--data_dir", str(root / "Panoptic"), *flags]
    ref_out = _run_reference("extract_training_poses",
                             argv + ["--out", str(tmp_path / "ref.pkl")],
                             monkeypatch)
    out = _run_port("extract_training_poses",
                    argv + ["--out", str(tmp_path / "port.pkl")])
    assert out.replace("port.pkl", "ref.pkl") == ref_out
    with open(tmp_path / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp_path / "port.pkl", "rb") as f:
        got = pickle.load(f)
    assert len(got) == len(ref) > 0
    J = 17 if "--coco17" in flags else 15
    for a, b in zip(got, ref):
        assert a["pose"].shape == (J, 3) and a["vis"].shape == (J, 4)
        np.testing.assert_array_equal(a["pose"], b["pose"])
        np.testing.assert_array_equal(a["vis"], b["vis"])
    if "--max_poses" in flags:
        assert len(got) >= 7
    if J == 15:                      # root-centred in xy
        assert all(not p["pose"][2, :2].any() for p in got)


@pytest.mark.parametrize("dry_run", [False, True], ids=["write", "dry_run"])
def test_preprocess_matches_reference(tmp_path, dry_run, monkeypatch):
    import cv2

    rng = np.random.RandomState(5)
    sides = {}
    for side in ("ref", "port"):
        cam = tmp_path / side / "Camera0"
        cam.mkdir(parents=True)
        sides[side] = tmp_path / side
    images = {"a.png": rng.randint(0, 256, (776, 1032, 3), np.uint8),
              "b.png": rng.randint(0, 256, (776, 1032, 3), np.uint8),
              # already at the working size: left as it is
              "c.png": rng.randint(0, 256, (608, 800, 3), np.uint8)}
    for side in sides.values():
        for name, img in images.items():
            cv2.imwrite(str(side / "Camera0" / name), img)
    flags = ["--dry-run"] if dry_run else []
    ref_out = _run_reference("preprocess", ["--dataset", "shelf", "--dir",
                                            str(sides["ref"]), *flags],
                             monkeypatch)
    out = _run_port("preprocess", ["--dataset", "shelf", "--dir",
                                   str(sides["port"]), *flags])
    assert out == ref_out and "resized 2 images" in out
    for name, img in images.items():
        a = (sides["port"] / "Camera0" / name).read_bytes()
        b = (sides["ref"] / "Camera0" / name).read_bytes()
        assert a == b
        got = cv2.imread(str(sides["port"] / "Camera0" / name))
        if dry_run or name == "c.png":
            np.testing.assert_array_equal(got, img)
        else:
            assert got.shape == (608, 800, 3)


@pytest.mark.parametrize("tool", ["check_space_center",
                                  "check_midpoint_hypothesis"])
@pytest.mark.parametrize("cfg,split", [("panoptic", "test"),
                                       ("shelf", "train"),
                                       ("campus", "train")])
def test_check_tools_match_reference(trees, tool, cfg, split, monkeypatch):
    cfgs = trees[1]
    argv = ["--cfg", cfgs[cfg], "--split", split]
    _no_cache(cfgs[cfg])
    ref_out = _run_reference(tool, argv, monkeypatch)
    _no_cache(cfgs[cfg])
    out = _run_port(tool, argv)
    assert out == ref_out
    assert "no GT poses found" not in out and "SPACE_CENTER" in out


def test_check_midpoint_visualize(trees, tmp_path):
    cfgs = trees[1]
    png = tmp_path / "mid.png"
    out = _run_port("check_midpoint_hypothesis",
                    ["--cfg", cfgs["shelf"], "--split", "train",
                     "--visualize", "--out", str(png)])
    assert f"wrote {png}" in out and png.stat().st_size > 0


@pytest.mark.parametrize("cfg", ["shelf", "campus"])
def test_visualize_cameras_matches_reference(trees, tmp_path, cfg,
                                             monkeypatch):
    from mpl_toolkits.mplot3d.axes3d import Axes3D

    cfgs = trees[1]
    seen = []
    scatter = Axes3D.scatter

    def record(self, *args, **kw):
        seen[-1].append(np.asarray(args[:3], np.float64).ravel())
        return scatter(self, *args, **kw)

    monkeypatch.setattr(Axes3D, "scatter", record)
    pngs = [tmp_path / "ref.png", tmp_path / "port.png"]
    seen.append([])
    ref_out = _run_reference("visualize_cameras",
                             ["--cfg", cfgs[cfg], "--out", str(pngs[0])],
                             monkeypatch)
    seen.append([])
    out = _run_port("visualize_cameras", ["--cfg", cfgs[cfg], "--out",
                                          str(pngs[1])])
    assert out.replace("port.png", "ref.png") == ref_out
    assert all(p.stat().st_size > 0 for p in pngs)
    views = 5 if cfg == "shelf" else 3
    assert len(seen[1]) == len(seen[0]) == views
    np.testing.assert_array_equal(np.stack(seen[1]), np.stack(seen[0]))


# a stand-in for run/train_torch.py: the first launch prints a step line
# and hangs; a launch with --resume hangs without a word (no progress); with
# EXIT set in its environment, the first launch exits 3 and a resumed one 0
STUB = textwrap.dedent("""\
    import faulthandler, os, signal, sys, time
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    if os.environ.get("STUB_EXIT"):
        sys.exit(0 if "--resume" in sys.argv else 3)
    if "--resume" not in sys.argv:
        print("epoch 0 [0/9] loss 1.0", flush=True)
    time.sleep(60)
    """)


def _supervise(tmp_path, monkeypatch, max_restarts):
    from fvp_torch.tools import train_supervisor as sup

    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    monkeypatch.setattr(sup, "TRAIN_SCRIPT", str(stub))
    monkeypatch.setattr(sup, "POLL_S", 0.1)
    monkeypatch.setattr(sup, "RELAUNCH_PAUSE_S", 0.1)
    log = tmp_path / "sup.log"
    out = io.StringIO()

    def too_long(*_):
        raise TimeoutError(f"the supervisor ran on:\n{out.getvalue()}")

    # a supervisor that never stops fails the test instead of hanging it
    previous = signal.signal(signal.SIGALRM, too_long)
    signal.alarm(60)
    try:
        with contextlib.redirect_stdout(out):
            rc = sup.main(["--cfg", "x.yaml", "--save-every", "7",
                           "--stall-timeout", "1", "--compile-timeout", "1",
                           "--grace", "0.3", "--max-restarts",
                           str(max_restarts), "--log", str(log), "--",
                           "--device", "cpu"])
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
    return rc, out.getvalue(), log.read_text()


def test_supervisor_restarts_a_stall_and_gives_up(tmp_path, monkeypatch):
    monkeypatch.delenv("STUB_EXIT", raising=False)
    rc, out, log = _supervise(tmp_path, monkeypatch, max_restarts=1)
    assert rc == 1
    assert out.count("supervisor: attempt") == 3
    assert out.count("no log progress for 1s") == 3
    assert "2 consecutive attempts with zero progress — giving up" in out
    launches = [s for s in log.splitlines()
                if s.startswith("=== supervisor: launching")]
    assert len(launches) == 3
    assert "--resume" not in launches[0]
    assert all(s.endswith("--resume ===") for s in launches[1:])
    assert "--cfg x.yaml --save-every 7 --device cpu" in launches[0]
    # SIGUSR1 before the kill: the child's faulthandler dumped its stacks
    assert log.count("most recent call first") >= 3


def test_supervisor_resumes_after_an_exit(tmp_path, monkeypatch):
    monkeypatch.setenv("STUB_EXIT", "1")
    rc, out, log = _supervise(tmp_path, monkeypatch, max_restarts=1)
    assert rc == 0
    assert "child exited rc=3; restarting with --resume" in out
    assert "training completed" in out
    assert log.count("=== supervisor: launching") == 2


def _same(a, b, where="") -> None:
    """Recursive equality of records: dicts, lists, numpy arrays and
    scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)


@pytest.mark.parametrize("name", ["panoptic", "shelf", "campus"])
def test_fixture_trees_load_alike(trees, name):
    import fvp_tpu.config as ref_config
    import fvp_tpu.data.registry as ref_registry

    from fvp_torch.config import load_config
    from fvp_torch.data.registry import build_dataset

    _, cfgs, shelf_gt = trees
    _no_cache(cfgs[name])
    ref = ref_registry.build_dataset(
        name, ref_config.load_config(cfgs[name]), is_train=False)
    _no_cache(cfgs[name])
    got = build_dataset(name, load_config(cfgs[name]), is_train=False)
    assert len(got.records) > 0
    _same(got.records, ref.records)
    assert got.rigs.keys() == ref.rigs.keys()
    for seq in got.rigs:
        for field in ("R", "T", "f", "c", "k", "p"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got.rigs[seq], field)),
                np.asarray(getattr(ref.rigs[seq], field)))
    if name == "campus":
        assert [r["frame"] for r in got.records] == list(
            fixtures.CAMPUS_FRAMES)
    if name == "shelf":
        assert [r["frame"] for r in got.records] == list(
            fixtures.SHELF_FRAMES)
        # the oracle poses (the GT itself) score PCP 1 in both evaluators
        preds = np.zeros((len(got.records), 10, 17, 5), np.float32)
        preds[:, :, 0, 3] = -1.0
        for i, fi in enumerate(fixtures.SHELF_FRAMES):
            for n, coco in enumerate(shelf_gt[fi]):
                preds[i, n, :, :3] = coco
                preds[i, n, 0, 3] = 1.0
        m_ref, m_got = ref.evaluate(preds), got.evaluate(preds)
        _same(m_got, m_ref)
        assert m_got["avg_pcp"] > 0.999
