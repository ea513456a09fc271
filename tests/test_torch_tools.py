"""gslm_tpu_torch's COLMAP converter (tools/convert.py) against
gslm_tpu's.

A stub ``colmap`` on ``--colmap_executable`` logs its arguments and makes
the folders the real one would. Both packages run the same command list
(paths relative to the scene), move the sparse model into ``sparse/0``
alike, and write ``images_{2,4,8}`` whose pixels equal Pillow's LANCZOS
resize bit for bit (PNG through the port's codec); JPEG goes through
Pillow in both, and the two files decode alike."""

import json
import os
import shutil
import stat
import sys

import numpy as np
import pytest
from PIL import Image

from gslm_tpu.tools import convert as j_convert
from gslm_tpu_torch.data.png import read_png
from gslm_tpu_torch.tools import convert
from torch_threads import one_thread  # noqa: F401 (autouse)

_STUB = """#!{python}
import json, os, shutil, sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
opt = dict(zip(args[1::2], args[2::2]))
if args[0] == "mapper":
    os.makedirs(os.path.join(opt["--output_path"], "0"), exist_ok=True)
elif args[0] == "image_undistorter":
    out = opt["--output_path"]
    shutil.copytree(opt["--image_path"], os.path.join(out, "images"))
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(out, "sparse", name), "w") as f:
            f.write(name)
"""

MODES = {"RGB": 3, "RGBA": 4, "L": 1}


def _scene(root):
    """<root>/input with PNGs of three modes and odd sizes, and a JPEG."""
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "input"))
    for i, (mode, c) in enumerate(MODES.items()):
        h, w = 37 + 8 * i, 61 - 5 * i
        px = rng.integers(0, 256, (h, w, c), np.uint8)
        Image.fromarray(px[..., 0] if c == 1 else px, mode).save(
            os.path.join(root, "input", f"img{i}.png"))
    Image.fromarray(rng.integers(0, 256, (40, 48, 3), np.uint8)).save(
        os.path.join(root, "input", "img3.jpg"))
    return root


def _stub(path, log):
    with open(path, "w") as f:
        f.write(_STUB.format(python=sys.executable, log=log))
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


def _log(path, src):
    with open(path) as f:
        return [[a.replace(src, "<src>") for a in json.loads(line)]
                for line in f]


@pytest.mark.parametrize("flags", [["--resize"], ["--no_gpu",
                                                   "--camera", "PINHOLE"],
                                   ["--skip_matching", "--resize"]])
def test_convert_matches_jax(tmp_path, monkeypatch, capsys, flags):
    runs = {}
    for name in ("jax", "port"):
        src = _scene(str(tmp_path / name))
        stub = _stub(str(tmp_path / f"colmap_{name}"),
                     str(tmp_path / f"{name}.log"))
        argv = ["-s", src, "--colmap_executable", stub] + flags
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["convert"] + argv)
            j_convert.main()
        else:
            convert.main(argv)
        runs[name] = src
    j_log = _log(str(tmp_path / "jax.log"), runs["jax"])
    p_log = _log(str(tmp_path / "port.log"), runs["port"])
    assert p_log == j_log
    assert [a[0] for a in p_log] == (
        ["image_undistorter"] if "--skip_matching" in flags else
        ["feature_extractor", "exhaustive_matcher", "mapper",
         "image_undistorter"])
    for name, src in runs.items():
        assert sorted(os.listdir(os.path.join(src, "sparse"))) == ["0"]
        assert sorted(os.listdir(os.path.join(src, "sparse", "0"))) == [
            "cameras.bin", "images.bin", "points3D.bin"], name
    resized = [d for d in sorted(os.listdir(runs["port"]))
               if d.startswith("images_")]
    want_dirs = ["images_2", "images_4", "images_8"] \
        if "--resize" in flags else []
    assert resized == want_dirs
    assert [d for d in sorted(os.listdir(runs["jax"]))
            if d.startswith("images_")] == want_dirs
    for d in resized:
        names = sorted(os.listdir(os.path.join(runs["port"], d)))
        assert names == sorted(os.listdir(os.path.join(runs["jax"], d)))
        div = int(d.split("_")[1])
        for n in names:
            mine = os.path.join(runs["port"], d, n)
            theirs = np.asarray(Image.open(os.path.join(runs["jax"], d, n)))
            src_img = Image.open(os.path.join(runs["port"], "images", n))
            want = np.asarray(src_img.resize(
                (src_img.width // div, src_img.height // div),
                Image.LANCZOS))
            got = np.asarray(Image.open(mine))
            # a JPEG is saved lossily by Pillow in both packages
            np.testing.assert_array_equal(got, theirs, err_msg=f"{d}/{n}")
            if n.endswith(".png"):
                np.testing.assert_array_equal(got, want, err_msg=f"{d}/{n}")
                img = read_png(mine)
                np.testing.assert_array_equal(
                    img[..., 0] if img.shape[2] == 1 else img, want)
    assert capsys.readouterr().out.count("Done.") == 2


def test_convert_jpeg_needs_pillow(tmp_path, monkeypatch):
    src = _scene(str(tmp_path / "s"))
    shutil.copytree(os.path.join(src, "input"), os.path.join(src, "images"))
    out = str(tmp_path / "half.jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    convert.downscale(os.path.join(src, "images", "img0.png"),
                      str(tmp_path / "half.png"), 2)
    with pytest.raises(ImportError, match=r"\.jpg image needs Pillow"):
        convert.downscale(os.path.join(src, "images", "img3.jpg"), out, 2)


def test_convert_without_colmap_exits(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(SystemExit) as e:
        convert.main(["-s", str(tmp_path)])
    assert e.value.code == 1
    assert "COLMAP executable not found" in capsys.readouterr().out
