"""The port's dataset tool, `python -m pvpuformer_tpu_torch.prepare_data`,
against the JAX package's `scripts/prepare_data.py` (loaded by path), and
the port's eleven file-backed evaluation readers and SBD_Train against the
JAX package's `get_dataset`.

Fixture files are byte-equal to JAX's within one interpreter (the same PIL
and scipy writers from the same draws; scipy stamps each .mat header with
the clock to the second, so both writers get one fixed stamp). Every
reader gives JAX's length, images, object ids and masks on fixtures of its
layout: JAX's own fixtures for six layouts, and files written here, from
the readers' docstrings, for BraTS, ssTEM, OAIZIB, HARD, ADE20K and the
SBD train split. `commands` and `check` print what JAX's print but for the
CLI's name; the rehearsal's runs are JAX's with --device for --platform,
and its config 1 runs on the CPU."""
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.io import savemat
from scipy.io.matlab import _mio5

from pvpuformer_tpu.inference import datasets as jdatasets
from pvpuformer_tpu_torch import evaluate as port_cli
from pvpuformer_tpu_torch import prepare_data
from pvpuformer_tpu_torch.inference import datasets as pdatasets

REPO = Path(__file__).resolve().parents[1]
JAX_CLI = "python scripts/evaluate.py"
READERS = ["GrabCut", "Berkeley", "DAVIS", "COCO_MVal", "PascalVOC", "SBD",
           "SBD_Train", "BraTS", "ssTEM", "OAIZIB", "HARD", "ADE20K"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_data", REPO / "scripts" / "prepare_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tool():
    return _jax_tool()


@pytest.fixture
def fixed_mat_stamp(monkeypatch):
    """One creation stamp for every .mat header written in the test."""
    monkeypatch.setattr(_mio5, "time", types.SimpleNamespace(
        asctime=lambda: "Thu Jan  1 00:00:00 1970"))


def _files(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_fixtures_are_byte_equal_to_jax(tmp_path, jax_tool, fixed_mat_stamp):
    jcfg = jax_tool.write_fixtures(tmp_path / "jax")
    pcfg = prepare_data.write_fixtures(tmp_path / "port")
    jfiles, pfiles = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(jfiles) == sorted(pfiles)
    assert len(pfiles) == 15
    for name, data in jfiles.items():
        if name == "config.yml":        # each names its own directory
            data = data.replace(str(tmp_path / "jax").encode(),
                                str(tmp_path / "port").encode())
        assert pfiles[name] == data, name
    assert pcfg.name == jcfg.name == "config.yml"


def _png(path: Path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.asarray(arr, np.uint8)).save(path)


def _extra_layouts(root: Path, r):
    """Fixtures of the layouts JAX's tool does not write, from the readers'
    docstrings: {name: path}."""
    h, w = 40, 50

    def rgb():
        return r.integers(0, 255, (h, w, 3))

    def gray():
        return r.integers(0, 255, (h, w))

    blob = np.zeros((h, w), np.uint8)
    blob[10:30, 15:35] = 1
    # BraTS: images/*.png + masks/*.png slices, mask nonzero = tumor
    for i in range(2):
        _png(root / "BraTS" / "images" / f"s{i}.png", gray())
        _png(root / "BraTS" / "masks" / f"s{i}.png", blob * (i + 1))
    # ssTEM: raw/ EM slices + mitochondria/ labels
    _png(root / "ssTEM" / "raw" / "00.png", gray())
    _png(root / "ssTEM" / "mitochondria" / "00.png", blob * 255)
    # OAIZIB: images/*.png + masks/*.png, labels 1..4 each an instance
    lab = np.zeros((h, w), np.uint8)
    lab[0:10, :] = 1
    lab[10:20, :] = 2
    lab[25:30, 5:20] = 4
    _png(root / "OAIZIB" / "images" / "k0.png", gray())
    _png(root / "OAIZIB" / "masks" / "k0.png", lab)
    # HARD: images/*.jpg + masks/*.png
    _png(root / "HARD" / "images" / "h0.jpg", rgb())
    _png(root / "HARD" / "masks" / "h0.png", blob * 255)
    # ADE20K: images/validation/*.jpg + annotations_instance/validation/
    # *.png with class in R and instance in G (instance 1 of two classes),
    # and one single-channel annotation
    ann = np.zeros((h, w, 3), np.uint8)
    ann[0:10, 0:20] = (3, 1, 0)
    ann[0:10, 20:40] = (7, 1, 0)
    ann[20:30, 0:20] = (3, 2, 0)
    ann[30:40, 30:50] = (9, 0, 0)           # a class without an instance
    ade = root / "ADE20K"
    _png(ade / "images" / "validation" / "a0.jpg", rgb())
    _png(ade / "annotations_instance" / "validation" / "a0.png", ann)
    _png(ade / "images" / "validation" / "a1.jpg", rgb())
    _png(ade / "annotations_instance" / "validation" / "a1.png", lab)
    return {"BraTS": root / "BraTS", "ssTEM": root / "ssTEM",
            "OAIZIB": root / "OAIZIB", "HARD": root / "HARD",
            "ADE20K": ade}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """{reader name: its fixture directory}."""
    root = tmp_path_factory.mktemp("layouts")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_mio5, "time", types.SimpleNamespace(
            asctime=lambda: "Thu Jan  1 00:00:00 1970"))
        prepare_data.write_fixtures(root)
        # a second SBD image with two instances, and the train split
        r = np.random.default_rng(5)
        sbd = root / "SBD"
        _png(sbd / "img" / "x2.jpg", r.integers(0, 255, (80, 100, 3)))
        inst = np.zeros((80, 100), np.uint8)
        inst[5:30, 5:40] = 1
        inst[40:70, 50:90] = 2
        savemat(str(sbd / "inst" / "x2.mat"),
                {"GTinst": np.array([[(inst,)]],
                                    dtype=[("Segmentation", "O")])})
        (sbd / "train.txt").write_text("x2\nx1\n")
        paths = {"GrabCut": root / "GrabCut", "Berkeley": root / "Berkeley",
                 "DAVIS": root / "DAVIS", "COCO_MVal": root / "COCO_MVal",
                 "PascalVOC": root / "VOC2012", "SBD": sbd, "SBD_Train": sbd}
        paths.update(_extra_layouts(root, r))
    return paths


@pytest.mark.parametrize("name", READERS)
def test_reader_matches_jax(name, layouts):
    jds = jdatasets.get_dataset(name, str(layouts[name]))
    pds = pdatasets.get_dataset(name, str(layouts[name]))
    assert len(pds) == len(jds) > 0
    objects = 0
    for i in range(len(jds)):
        js, ps = jds.get_sample(i), pds.get_sample(i)
        assert ps.image.dtype == js.image.dtype == np.uint8
        assert ps.image.shape == js.image.shape and ps.image.shape[2] == 3
        np.testing.assert_array_equal(ps.image, js.image)
        assert ps.objects_ids == js.objects_ids
        for obj in js.objects_ids:
            jm, pm = np.asarray(js.gt_mask(obj)), ps.gt_mask(obj)
            assert pm.dtype == jm.dtype
            np.testing.assert_array_equal(pm, jm)
            objects += 1
    # every layout's fixture has at least one object, more where the
    # layout keys several
    assert objects >= {"PascalVOC": 2, "SBD": 1, "SBD_Train": 3,
                       "OAIZIB": 3, "ADE20K": 6}.get(name, 1)


def _run(tool_main, monkeypatch, capsys, argv, jax_style):
    if jax_style:
        monkeypatch.setattr(sys, "argv", ["prepare_data.py"] + argv)
        rc = tool_main()
    else:
        rc = tool_main(argv)
    return rc, capsys.readouterr().out


def test_commands_print_what_jax_prints(jax_tool, monkeypatch, capsys):
    jrc, jout = _run(jax_tool.main, monkeypatch, capsys, ["commands"], True)
    prc, pout = _run(prepare_data.main, monkeypatch, capsys, ["commands"],
                     False)
    assert prc == jrc == 0
    assert pout.count(prepare_data.CLI) == 6
    assert pout.replace(prepare_data.CLI, JAX_CLI) == jout
    # each printed command parses in the port's evaluation CLI
    for line in pout.splitlines():
        if line.startswith(prepare_data.CLI):
            port_cli.parse_args(line.split()[3:])


def _broken(root: Path) -> Path:
    """A config whose paths exist but do not parse: an empty GrabCut, a VOC
    without its split file, an SBD whose split names a missing image."""
    (root / "GrabCut").mkdir(parents=True)
    (root / "VOC2012").mkdir()
    (root / "SBD").mkdir()
    (root / "SBD" / "val.txt").write_text("nothere\n")
    cfg = root / "config.yml"
    cfg.write_text(f"GRABCUT_PATH: {root / 'GrabCut'}\n"
                   f"PASCALVOC_PATH: {root / 'VOC2012'}\n"
                   f"SBD_EVAL_PATH: {root / 'SBD'}\n"
                   f"SBD_PATH: {root / 'SBD'}\n")
    return cfg


def _fixtures_config(root: Path, layouts) -> Path:
    """Every evaluation key at its fixture; both training keys at the SBD
    fixture (the tool only checks that they exist)."""
    keys = {name: prepare_data.DATASETS[name][0] for name in
            prepare_data.DATASETS}
    lines = [f"{keys[n]}: {layouts[n]}" for n in keys]
    lines += [f"LVIS_v1_PATH: {layouts['SBD']}", f"SBD_PATH: {layouts['SBD']}"]
    cfg = root / "config.yml"
    cfg.write_text("\n".join(lines) + "\n")
    return cfg


@pytest.mark.parametrize("which", ["repo", "fixtures", "broken"])
def test_check_prints_what_jax_prints(which, jax_tool, layouts, tmp_path,
                                      monkeypatch, capsys):
    argv = ["check"]
    if which == "fixtures":
        argv += ["--config", str(_fixtures_config(tmp_path, layouts))]
    elif which == "broken":
        argv += ["--config", str(_broken(tmp_path))]
    jrc, jout = _run(jax_tool.main, monkeypatch, capsys, argv, True)
    prc, pout = _run(prepare_data.main, monkeypatch, capsys, argv, False)
    assert pout == jout
    assert prc == jrc
    status = {ln.split()[0]: ln.split()[1] for ln in pout.splitlines()
              if ln and not ln.startswith(" ")}
    assert len(status) == 13
    if which == "fixtures":
        assert set(status.values()) == {"PRESENT"} and prc == 0
    elif which == "broken":
        assert [n for n, s in status.items() if s == "BROKEN"] == \
            ["GrabCut", "PascalVOC", "SBD"]
        assert status["SBD_train"] == "PRESENT" and prc == 1
    else:
        assert prc == 1


def test_rehearsal_runs_are_jax_runs(jax_tool, tmp_path, monkeypatch):
    """The six runs, with their titles, are the JAX tool's argv with the
    port's CLI and --device for --platform."""
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(jax_tool.subprocess, "run", fake_run)
    titles = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: titles.append(
        " ".join(map(str, a))))
    args = types.SimpleNamespace(out=str(tmp_path / "jax"), platform="cpu",
                                 skip_large=False)
    assert jax_tool.cmd_rehearse(args) == 0
    monkeypatch.undo()
    cfg = prepare_data.write_fixtures(tmp_path / "port")
    runs = prepare_data.rehearsal_runs(cfg, tmp_path / "port", "cpu")
    assert len(runs) == len(seen) == 6
    jtitles = [t[len("--- rehearsing BASELINE "):] for t in titles
               if t.startswith("--- rehearsing")]
    assert [t for t, _ in runs] == jtitles
    for (_, cmd), jcmd in zip(runs, seen):
        assert cmd[:3] == [sys.executable, "-m",
                           "pvpuformer_tpu_torch.evaluate"]
        assert jcmd[:2] == [sys.executable, "scripts/evaluate.py"]
        port = [a.replace(str(tmp_path / "port"), "OUT") for a in cmd[3:]]
        jax = [a.replace(str(tmp_path / "jax"), "OUT") for a in jcmd[2:]]
        jax[jax.index("--platform")] = "--device"
        assert port == jax
        parsed = port_cli.parse_args(cmd[3:])
        assert parsed.random_weights and parsed.device == "cpu"
    sizes = [port_cli.parse_args(c[3:]).model_size for _, c in runs]
    assert sizes == ["base"] * 4 + ["large", "huge"]
    assert len(prepare_data.rehearsal_runs(cfg, tmp_path, "cpu",
                                           skip_large=True)) == 4


def test_rehearsal_config_1_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Config 1 (ViT-B@448 on GrabCut, one click) as a process through the
    port's CLI with --device cpu."""
    runs = prepare_data.rehearsal_runs
    monkeypatch.setattr(prepare_data, "rehearsal_runs",
                        lambda *a, **k: runs(*a, **k)[:1])
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    rc = prepare_data.main(["rehearse", "--out", str(tmp_path), "--device",
                            "cpu", "--skip-large"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "--- rehearsing BASELINE config 1 (ViT-B GrabCut 1-click)" in out
    assert "ALL BASELINE commands ran end-to-end" in out
    row = [ln for ln in out.splitlines() if "|  GrabCut  |" in ln]
    assert len(row) == 1 and "(rc 0 in " in out
    assert "mIoU@k:" in out


def test_rehearsal_needs_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_data.main(["rehearse", "--out", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()
