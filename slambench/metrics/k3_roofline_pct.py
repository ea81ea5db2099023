"""K3 (csrc/min_eig.cu, min_eig_kernel) against its bound: the image's
bytes read once (uint8) and the f32 response written once, at the
published 3.35 TB/s of H100 HBM3, over K3's mean device time in the
trace, in %. Its ~55 flop a pixel at 67 Tflop/s take less."""

from slambench.harness import roofline


def read(run):
    t = roofline.kernel_mean_s(run, "min_eig_kernel")
    if t is None:
        return None
    h, w = run.cam["height"], run.cam["width"]
    return 100.0 * roofline.bound_s(roofline.min_eig_bytes(h, w), roofline.min_eig_flops(h, w)) / t
