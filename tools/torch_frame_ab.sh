#!/bin/bash
# Frames of the PyTorch port at 1920x1080 in two source trees, on one card in
# one call, in turns (A, B, B, A):
#
#     bash tools/torch_frame_ab.sh TREE_A TREE_B [FRAMES] [PATH] [SCENES]
#
# Each tree is a checkout of the repo (for an earlier commit: `git archive`
# unpacked into a gitignored directory). Every turn is a fresh process that
# runs this checkout's `chip_smoke.frame_phase` on the tree's own package
# (`kajiya_tpu_torch` and its kernels, imported from the tree), so both trees
# render the same scenes (chip_smoke.PATH_SCENES[PATH], each for FRAMES
# frames, default 12, with no per-scene cap) with the same launch counts
# asserted. PATH: gi (default), raster, default, options, refpt; a tree must
# have the path (default from the default-frame slice on, options and refpt
# from the path-tracer slice on). SCENES, a comma-separated subset of the
# path's scenes, renders only those. Prints the frame times in ms; the first
# frames of a process carry its warm-up. Frames of a few thousand small
# launches are bound by the host, so read the spread between the two turns
# of one tree before the difference between the trees.
set -e
frames=${3:-12}
path=${4:-gi}
scenes=${5:-}
here=$(cd "$(dirname "$0")/.." && pwd)
run() {
  (cd "$1" && python3 -c "
import importlib.util, os, statistics, sys, tempfile, torch
sys.path.insert(0, os.getcwd())
spec = importlib.util.spec_from_file_location('chip_smoke', '$here/chip_smoke.py')
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)
import kajiya_tpu_torch
assert os.path.dirname(kajiya_tpu_torch.__file__) == os.path.join(os.getcwd(), 'kajiya_tpu_torch')
chip_smoke.N_FRAMES['$path'] = $frames
chip_smoke.FRAME_CAP.clear()
if '$scenes':
    chip_smoke.PATH_SCENES['$path'] = tuple('$scenes'.split(','))
ibl = os.path.join(tempfile.mkdtemp(), 'sky.hdr')
chip_smoke.write_panorama(ibl)
res = chip_smoke.frame_phase(torch.device('cuda', 0), '$path', ibl)
for name, r in res.items():
    ms = r['frame_ms']
    print('$2', name, 'median of frames 2.. %.2f ms;' % statistics.median(ms[2:]),
          ' '.join('%.1f' % t for t in ms))
" 2>>"$here/chiprun_out/torch_frame_ab.err")
}
mkdir -p "$here/chiprun_out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run "$1" A
run "$2" B
run "$2" B
run "$1" A
