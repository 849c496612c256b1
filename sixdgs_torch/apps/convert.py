"""COLMAP SfM preprocessing wrapper: port of sixdgs_tpu/apps/convert.py
(the reference's convert.py:17-124).

Runs feature extraction -> exhaustive matching -> mapper -> image undistortion
via the external ``colmap`` binary, moves the undistorted model into
``sparse/0``, then optionally writes downscaled image sets through
ImageMagick. The binary is not bundled; the script exits with a clear
message when it is absent. Nothing here needs torch.

Usage:
    python -m sixdgs_torch.apps.convert -s <dir with input/ images> [--no_gpu]
        [--skip_matching] [--resize] [--camera OPENCV] [--colmap_executable ...]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def run(cmd: str) -> None:
    print("+", cmd)
    exit_code = subprocess.call(cmd, shell=True)
    if exit_code != 0:
        print(f"command failed with code {exit_code}. Exiting.")
        sys.exit(exit_code)


def main(argv=None):
    parser = argparse.ArgumentParser(description="sixdgs_torch COLMAP converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="")
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="")
    args = parser.parse_args(argv)

    colmap = args.colmap_executable or "colmap"
    magick = args.magick_executable or "magick"
    if shutil.which(colmap.split()[0]) is None:
        print(
            f"COLMAP executable {colmap!r} not found on PATH. Install COLMAP or "
            "pass --colmap_executable."
        )
        sys.exit(1)
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted/sparse"), exist_ok=True)
        run(
            f"{colmap} feature_extractor"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --ImageReader.single_camera 1"
            f" --ImageReader.camera_model {args.camera}"
            f" --SiftExtraction.use_gpu {use_gpu}"
        )
        run(
            f"{colmap} exhaustive_matcher"
            f" --database_path {src}/distorted/database.db"
            f" --SiftMatching.use_gpu {use_gpu}"
        )
        run(
            f"{colmap} mapper"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --output_path {src}/distorted/sparse"
            f" --Mapper.ba_global_function_tolerance=0.000001"
        )

    run(
        f"{colmap} image_undistorter"
        f" --image_path {src}/input"
        f" --input_path {src}/distorted/sparse/0"
        f" --output_path {src}"
        f" --output_type COLMAP"
    )

    # move sparse files into sparse/0 (convert.py:86-97)
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for fname in os.listdir(sparse):
        if fname == "0":
            continue
        shutil.move(os.path.join(sparse, fname), os.path.join(sparse, "0", fname))

    if args.resize:
        print("Copying and resizing...")
        if shutil.which(magick.split()[0]) is None:
            print(f"ImageMagick executable {magick!r} not found; skipping resize")
            return
        for scale, dirname in ((50, "images_2"), (25, "images_4"), (12.5, "images_8")):
            out_dir = os.path.join(src, dirname)
            os.makedirs(out_dir, exist_ok=True)
            for file in os.listdir(os.path.join(src, "images")):
                source_file = os.path.join(src, "images", file)
                dest = os.path.join(out_dir, file)
                shutil.copy2(source_file, dest)
                run(f"{magick} mogrify -resize {scale}% {dest}")
    print("Done.")


if __name__ == "__main__":
    main()
