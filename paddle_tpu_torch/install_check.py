"""fluid.install_check.run_check() (reference
python/paddle/fluid/install_check.py), the port's copy of
``paddle_tpu/install_check.py``: train one tiny fc step end to end (DSL ->
IR -> backward -> optimizer -> the executor) and report success. It runs on
the card, where the SGD update is one launch of the ``multi_tensor_update``
kernel (its ``sgd`` kind), and raises when there is no card unless the
caller passes ``CPUPlace()``, as the ``Executor`` does."""
from __future__ import annotations

import numpy as np


def run_check(place=None):
    from . import (Executor, Program, Scope, data, layers, optimizer, program_guard,
                   scope_guard, unique_name)

    main, startup = Program(), Program()
    main.random_seed = 0
    startup.random_seed = 0
    with unique_name.guard(), program_guard(main, startup):
        x = data("install_check_x", [4], "float32")
        label = data("install_check_y", [1], "int64")
        loss = layers.mean(layers.softmax_with_cross_entropy(layers.fc(x, 4), label))
        optimizer.SGD(0.1).minimize(loss)
    rng = np.random.RandomState(0)
    exe = Executor(place)
    with scope_guard(Scope()):
        exe.run(startup)
        lv, = exe.run(main,
                      feed={"install_check_x": rng.randn(8, 4).astype("float32"),
                            "install_check_y": rng.randint(0, 4, (8, 1)).astype("int64")},
                      fetch_list=[loss])
    assert np.isfinite(np.asarray(lv)).all()
    if exe.device.type == "cuda":
        import torch
        where = f"GPU ({torch.cuda.get_device_name(exe.device)})"
    else:
        where = "CPU (cpu)"
    print(f"Your paddle_tpu_torch works well on {where}.")
    print("Your paddle_tpu_torch is installed successfully!")
