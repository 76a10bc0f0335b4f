"""The playground, port of threedgrut_tpu/playground/: a path tracer over
Gaussians and triangle meshes (engine.py: the hybrid 3DGRUT mode
rasterizes primary rays and traces secondary ones), its materials, meshes
(mesh closest-hit: kernel M1, ops/mesh_intersect.py), glTF loader,
environment maps, denoisers, trajectory videos, an editable scene graph
and the web viewer. `python -m threedgrut_torch.playground` serves a
trained scene; `threedgrut_torch.gui.TrainingGUI` serves a live trainer.
"""
