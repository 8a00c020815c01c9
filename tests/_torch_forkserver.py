"""The fork server that the DataLoader tests of both packages share.

One fork server per process starts the workers of every DataLoader of
both packages, and the first loader to start it picks what it preloads: a
worker then imports what the server lacks (torch and a test module's
imports, seconds a worker). ``start_with_both_loaders`` starts it with
both packages' loader modules and pytest preloaded (a test module's
imports are then cheap), restarting one that a loader started.
"""
import multiprocessing.forkserver as fs


def start_with_both_loaders():
    server = fs._forkserver
    if server._forkserver_pid is not None and \
            getattr(server, "started_here", None) != server._forkserver_pid:
        server._stop()  # started by a loader, with its own preload only
    fs.set_forkserver_preload(["paddle_tpu.io.dataloader",
                               "paddle_tpu_torch.io.dataloader", "pytest"])
    fs.ensure_running()
    server.started_here = server._forkserver_pid
