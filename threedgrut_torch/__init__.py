"""PyTorch/CUDA port of the 3DGUT renderer and trainer and of the 3DGRT
tracer's forward of `threedgrut_tpu`.

The JAX package beside this one is the reference: every module here mirrors
its counterpart there and is held against it by the `tests/test_torch_*.py`
files. Importing this package needs only torch and numpy; the CUDA kernels
under `csrc/` are compiled on first use (`ops/cuda_build.py`), never at
import time.

Entry points: `python -m threedgrut_torch.train` and `python -m
threedgrut_torch.render` (train a scene from disk, render and score a
checkpoint); `api.load_scene` (.npz, .ply, .ingp), `api.render` (method
"3dgut" or "3dgrt"), `api.trace`, `render.gut.render`, `render.grt.trace`,
`render.infer` (frame-coherent inference: refresh, render_compact,
capture_binning, render_frozen), `export` (.ply, .ingp, .usdz; `python -m
threedgrut_torch.export.ply_to_usd`), `trainer.Trainer` (with
`datasets.make`: NeRF-synthetic, COLMAP, ScanNet++ or the synthetic
scene) and `render_eval.Renderer`. They run on the card (`device="cuda"`)
unless the caller asks for `device="cpu"`, where each kernel is replaced by
its plain PyTorch version.
"""
