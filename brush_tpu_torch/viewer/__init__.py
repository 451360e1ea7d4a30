"""Live web viewer (port of brush_tpu/viewer/; reference:
crates/brush-viewer).

A small HTTP server and a browser page: the training loop runs in a
background thread driven by a control-message queue (mirroring
train_loop.rs's channel protocol), and the browser drives an orbit camera
whose frames are rendered on the card through the u32 display path.
"""

from brush_tpu_torch.viewer.server import ViewerServer, run_viewer

__all__ = ["ViewerServer", "run_viewer"]
