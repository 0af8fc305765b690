"""Host time in the CU16 I-frame layer (engine/intra_encoder:
pack_upload, dispatch_packed, fetch_frames; the background fetch thread's
included) per I frame emitted in the window."""

from hevcbench.spans import layer_seconds

SPANS = {"intra": ("homerhevc_tpu_torch.engine.intra_encoder",
                   "TorchIntraEncoder",
                   ("pack_upload", "dispatch_packed", "fetch_frames"))}


def read(t):
    n = sum(f.ftype == "I" for f in t.window)
    if not n:
        return None
    return layer_seconds(t.spans, "intra") / n * 1e3
