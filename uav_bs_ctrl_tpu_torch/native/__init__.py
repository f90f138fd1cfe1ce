"""Native (C++) host runtime, loaded with ``ctypes`` (counterpart of
``uav_bs_ctrl_tpu/native``).

``env_core.cpp`` is the C++ twin of ``MultiUbsCoverageEnv._schedule_numpy``
(the host env's scheduler). ``build.py`` compiles it with the host C++
compiler into ``_build/libuavbs-<hash>.so`` at first use (or ``python -m
uav_bs_ctrl_tpu_torch.native.build``); ``env_core.py`` binds it. When it
cannot be built the host env falls back to its NumPy scheduler, warns once
with the compiler's error and records ``scheduler == 'numpy'``.
"""
