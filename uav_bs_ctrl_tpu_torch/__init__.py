"""PyTorch/CUDA port of ``uav_bs_ctrl_tpu``: train and serve policies on an H100.

The package imports torch and numpy only. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; see :mod:`uav_bs_ctrl_tpu_torch.run_fast`
(training runs) and :mod:`uav_bs_ctrl_tpu_torch.serve`.
"""
