"""A process of tests/test_torch_multihost.py: joins a world of two through
threedgrut_torch.parallel.multihost.initialize (gloo, the loopback), builds
the (2, 1, 1) mesh over it, loads only its own data row's view of each step
(my_view_indices, host_local_batch) and trains two DPTrainer steps, then
prints its views, the mean loss and a digest of its replicated state.

    python tests/torch_multihost_worker.py <process_id> <port>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from tests import torch_dp_workers as W  # noqa: E402


def main():
    pid, port = int(sys.argv[1]), int(sys.argv[2])
    torch.set_num_threads(1)
    from threedgrut_torch.parallel import multihost
    from threedgrut_torch.parallel.trainer import DPTrainer

    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=2, process_id=pid, backend="gloo")
    mesh = multihost.make_global_mesh(tile=1)
    assert mesh.shape == (2, 1, 1) and mesh.rank == pid
    ds = W.dataset()
    tr = DPTrainer(W.config(), ds, params=W.params_of(W.initial_fields(ds)),
                   device="cpu", mesh=mesh)
    rows, losses = [], []
    for step in range(2):
        mine = multihost.my_view_indices(len(ds), 2, step, mesh=mesh)
        views = multihost.host_local_batch(mesh, [ds[i] for i in mine])
        assert views[pid] is ds[mine[0]]
        aux = tr.train_step_batch(views)
        rows.append(mine[0])
        losses.append(float(aux["terms"]["total"]))
    print(f"MHOK pid={pid} rows={rows[0]},{rows[1]} "
          f"loss={losses[0]!r},{losses[1]!r} "
          f"digest={W.digest(W.state_of(tr))}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
