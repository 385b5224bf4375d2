"""Stock Horovod PyTorch scripts on the port, run as modules
(``python -m horovod_tpu_torch.examples.<name>``): ``pytorch_mnist``
(BASELINE.json config 1) and ``torch_resnet50`` (config 2's torch
half)."""
