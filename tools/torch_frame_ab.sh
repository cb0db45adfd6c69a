#!/bin/bash
# Frames of the PyTorch port at 1920x1080 in two source trees, on one card in
# one call, in turns (A, B, B, A):
#
#     bash tools/torch_frame_ab.sh TREE_A TREE_B [FRAMES] [PATH]
#
# Each tree is a checkout of the repo (for an earlier commit: `git archive`
# unpacked into a gitignored directory). Every turn is a fresh process that
# runs `chip_smoke.frame_phase` on PATH (default: gi; or raster; default,
# which a tree has only from the default-frame slice on; options and refpt,
# only from the path-tracer slice on; cornell, then the city) for FRAMES
# frames (default 12) with the launch counts asserted, and
# prints the frame times in ms; the first frames of a process carry its warm-up. Frames
# of a few thousand small launches are bound by the host, so read the spread
# between the two turns of one tree before the difference between the trees.
set -e
frames=${3:-12}
path=${4:-gi}
run() {
  (cd "$1" && python3 -c "
import statistics, sys, torch
sys.path.insert(0, '.')
import chip_smoke
import inspect, os, tempfile
chip_smoke.N_FRAMES['$path'] = $frames
args = [torch.device('cuda', 0), '$path']
if 'ibl' in inspect.signature(chip_smoke.frame_phase).parameters:
    ibl = os.path.join(tempfile.mkdtemp(), 'sky.hdr')
    chip_smoke.write_panorama(ibl)
    args.append(ibl)
res = chip_smoke.frame_phase(*args)
for name, r in res.items():
    ms = r['frame_ms']
    print('$2', name, 'median of frames 2.. %.2f ms;' % statistics.median(ms[2:]),
          ' '.join('%.1f' % t for t in ms))
" 2>/dev/null)
}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run "$1" A
run "$2" B
run "$2" B
run "$1" A
