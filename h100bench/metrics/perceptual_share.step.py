"""perceptual_share.step: the device time of the loss networks' terms inside
the train step (``loss/vgg_perceptual`` and ``loss/lpips``: their forwards on
the output and the target; their backward falls in ``train/backward``) over
the whole step's (``train/step``), both summed over the traced windows, in %.
Below ``perceptual_share``, which times forward and backward from outside."""

from h100bench.metrics._spans import share


def read(ctx):
    return share(ctx, ("loss/vgg_perceptual", "loss/lpips"), "train/step")
