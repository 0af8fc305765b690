"""Host time in the P-frame layer (engine/inter_encoder: dispatch and
fetch) per P frame emitted in the window."""

from hevcbench.spans import layer_seconds

SPANS = {"inter": ("homerhevc_tpu_torch.engine.inter_encoder",
                   "TorchInterEncoder", ("dispatch", "dispatch_b", "fetch"))}


def read(t):
    n = sum(f.ftype == "P" for f in t.window)
    if not n:
        return None
    return layer_seconds(t.spans, "inter") / n * 1e3
