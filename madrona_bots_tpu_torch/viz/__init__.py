from madrona_bots_tpu_torch.viz.viewer import ScriptBotsViewer

__all__ = ["ScriptBotsViewer"]
