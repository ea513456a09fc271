"""COLMAP dataset converter (gslm_tpu/tools/convert.py, the reference's
convert.py).

Runs COLMAP's feature_extractor → exhaustive_matcher → mapper →
image_undistorter on a raw ``<src>/input`` image folder, moves the sparse
model into ``sparse/0``, and with ``--resize`` writes 2x/4x/8x
downscaled copies (``images_2``, ``images_4``, ``images_8``) with
Pillow's LANCZOS filter. PNG images take the port's codec
(``data/png.py``: the same pixels as Pillow, without it); other formats
need Pillow, imported only for them. The COLMAP binary is required and
its absence is a clear error.

Usage: python -m gslm_tpu_torch.tools.convert -s <location> [--no_gpu]
       [--skip_matching] [--resize] [--camera OPENCV]
       [--colmap_executable PATH]
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from argparse import ArgumentParser

from gslm_tpu_torch.data.png import is_png, read_png, resize_uint8, write_png


def run(cmd: list[str]):
    print("+", " ".join(cmd))
    proc = subprocess.run(cmd)
    if proc.returncode != 0:
        print(f"command failed with code {proc.returncode}. Exiting.")
        sys.exit(proc.returncode)


def downscale(src_path: str, dst_path: str, div: int) -> None:
    """``Image.resize((w // div, h // div), Image.LANCZOS)`` of one image,
    saved to ``dst_path``: PNG through the port's codec, other formats
    through Pillow (``ImportError`` without it)."""
    if is_png(src_path):
        img = read_png(src_path)
        if img.shape[2] == 1:
            img = img[..., 0]
        h, w = img.shape[:2]
        write_png(dst_path, resize_uint8(img, (w // div, h // div),
                                         "lanczos"))
        return
    try:
        from PIL import Image
    except ImportError as e:
        ext = os.path.splitext(src_path)[1] or "non-PNG"
        raise ImportError(
            f"{src_path}: resizing a {ext} image needs Pillow, which is not "
            f"installed; the port resizes only PNG without it") from e
    with Image.open(src_path) as img:
        img.resize((img.width // div, img.height // div),
                   Image.LANCZOS).save(dst_path)


def main(argv=None):
    parser = ArgumentParser(description="COLMAP converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="")
    parser.add_argument("--resize", action="store_true")
    args = parser.parse_args(argv)

    colmap = args.colmap_executable or shutil.which("colmap")
    if not colmap:
        print("COLMAP executable not found; install colmap or pass "
              "--colmap_executable")
        sys.exit(1)
    use_gpu = "0" if args.no_gpu else "1"
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        run([colmap, "feature_extractor",
             "--database_path", os.path.join(src, "distorted", "database.db"),
             "--image_path", os.path.join(src, "input"),
             "--ImageReader.single_camera", "1",
             "--ImageReader.camera_model", args.camera,
             "--SiftExtraction.use_gpu", use_gpu])
        run([colmap, "exhaustive_matcher",
             "--database_path", os.path.join(src, "distorted", "database.db"),
             "--SiftMatching.use_gpu", use_gpu])
        run([colmap, "mapper",
             "--database_path", os.path.join(src, "distorted", "database.db"),
             "--image_path", os.path.join(src, "input"),
             "--output_path", os.path.join(src, "distorted", "sparse"),
             "--Mapper.ba_global_function_tolerance=0.000001"])

    # undistort into the layout the loaders expect (<src>/images + sparse/0)
    run([colmap, "image_undistorter",
         "--image_path", os.path.join(src, "input"),
         "--input_path", os.path.join(src, "distorted", "sparse", "0"),
         "--output_path", src, "--output_type", "COLMAP"])
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f != "0":
            shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if args.resize:
        for div in (2, 4, 8):
            out_dir = os.path.join(src, f"images_{div}")
            os.makedirs(out_dir, exist_ok=True)
            for name in os.listdir(os.path.join(src, "images")):
                downscale(os.path.join(src, "images", name),
                          os.path.join(out_dir, name), div)
    print("Done.")


if __name__ == "__main__":
    main()
