"""JSON-safe config conversion (a copy of ``uav_bs_ctrl_tpu/utils/serialization.py``;
parity: reference ``utils/serialization_utils.py``).

``config.json`` is load-bearing: evaluation reconstructs envs and args from it
(``test_policies.py``), so values must round-trip losslessly when they can and
degrade to informative names/strings when they can't.
"""

import json


def convert_json(obj):
    """Best-effort JSON form of an arbitrary config value.

    Containers recurse (tuples become lists); named objects (functions,
    classes) are represented by their ``__name__``; objects with state dump as
    ``{str(obj): {attr: value, ...}}``; everything else falls back to
    ``str(obj)``.
    """
    if is_json_serializable(obj):
        return obj
    if isinstance(obj, dict):
        return {convert_json(k): convert_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [convert_json(x) for x in obj]
    name = getattr(obj, '__name__', None)
    if name is not None and 'lambda' not in name:
        return convert_json(name)
    state = getattr(obj, '__dict__', None)
    if state:
        return {str(obj): {convert_json(k): convert_json(v)
                           for k, v in state.items()}}
    return str(obj)


def is_json_serializable(v):
    try:
        json.dumps(v)
        return True
    except Exception:
        return False
