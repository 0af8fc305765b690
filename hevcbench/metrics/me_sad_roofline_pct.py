"""The sweep kernel (csrc/me_sad.cu, coarse_sweep_kernel) against its
roofline: the least time of a call from its shapes (roofline.sweep_bound:
HBM at 3.35 TB/s, or the integer lanes at the card's maximum SM clock),
over the kernel's time in the device trace of the sub-window, in %. The
hook below keeps the shapes of each call the profiled frames make."""

from hevcbench.roofline import sweep_bound

KERNEL = "coarse_sweep_kernel"
SWEEP = ("homerhevc_tpu_torch.engine.inter_encoder", "coarse_sweep_sads")


def install(sp):
    import functools
    import importlib
    mod = importlib.import_module(SWEEP[0])
    orig = getattr(mod, SWEEP[1])
    shapes = sp.records.setdefault("me_sad", [])

    @functools.wraps(orig)
    def sweep(sd, rp, R, m, *a, **k):
        if sp.profiling:
            shapes.append((tuple(sd.shape), sd.element_size(), rp.numel(),
                           R, m))
        return orig(sd, rp, R, m, *a, **k)
    sp.patch(mod, SWEEP[1], sweep)


def read(t):
    shapes = t.records.get("me_sad")
    if t.trace is None or not shapes or not t.sms or not t.clock_hz:
        return None
    ks = [k for k in t.trace.kernels if KERNEL in k.name]
    if len(ks) != len(shapes):
        return None
    dev_ms = sum(k.end_us - k.start_us for k in ks) * 1e-3
    bound_ms = 0.0
    for shape, itemsize, rp_numel, R, m in shapes:
        n = 1
        for d in shape:
            n *= d
        bound_ms += sweep_bound(n, itemsize, rp_numel, R, m, t.sms,
                                t.clock_hz)[0]
    return bound_ms / dev_ms * 100.0
