"""Model FLOPs an image (the convolution and linear shapes of a train
step, ``roofline/flops.py``) times the run's images a second over its
unprofiled window, over the bfloat16 dense peak of the cards it runs on."""


def read(record):
    if record.kind != "train" or not record.flops_per_image or not record.unprofiled_img_s:
        return None
    return 100.0 * record.flops_per_image * record.unprofiled_img_s / record.peak_flops
