"""The command line: ``python -m acoustic_image_generation_tpu_torch.cli.main``
(train and test) and ``python -m acoustic_image_generation_tpu_torch.cli.tools``
(``iou``, ``auc``, ``generate``)."""
