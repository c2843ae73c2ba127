"""Host milliseconds per control step of the evaluation runner's own work
(stuck detector, RS takeover, freezing of finished episodes) on the traced
battery steps: its ``eval/step`` range less the ``policy/act`` and
``env/step`` ranges nested in it."""


def read(layer):
    tr = layer.get("trace")
    if tr is None or tr.units <= 0:
        return None
    if not {"eval/step", "policy/act", "env/step"} <= set(tr.spans):
        return None
    own = tr.spans["eval/step"][1] - tr.spans["policy/act"][1] - tr.spans["env/step"][1]
    return own * 1e3 / tr.units
