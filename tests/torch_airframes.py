"""A user airframe with a wing, for the port's tests.

`aw109_wing` is aw109 with its wing block set to five times the horizontal
tail's coefficients (aw109.yaml's HT block: ZUU 0.4, ZUW -34, ZMAX -22), the
wing at the centre of gravity. Neither committed airframe has a wing, so
this is what holds the kernels' winged instantiation and the registry of
user airframes. `write_winged(directory)` writes it as `aw109_wing.yaml`;
a test registers the directory with `register_model_path`.
"""
import os

NAME = "aw109_wing"
WING = {"ZUU": 2.0, "ZUW": -170.0, "ZMAX": -110.0}
AW109_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "heligym_tpu", "models", "aw109.yaml")


def winged_yaml(text: str) -> str:
    """aw109.yaml's text with its wing block set to WING, at the CG
    (FS 132.7, WL 38.5)."""
    value = {"FS": "132.7", "WL": "38.5", **{k: str(v) for k, v in WING.items()}}
    out, in_wn = [], False
    for line in text.splitlines():
        key = line.strip().split(":")[0]
        if line.startswith("    WN:"):
            in_wn = True
        elif in_wn and not line.startswith("        "):
            in_wn = False
        elif in_wn and key in value:
            line = f"        {key}: {value[key]}"
        out.append(line)
    return "\n".join(out) + "\n"


def write_winged(directory) -> str:
    """Write aw109_wing.yaml into `directory`; returns its path."""
    with open(AW109_YAML) as f:
        text = winged_yaml(f.read())
    path = os.path.join(str(directory), NAME + ".yaml")
    with open(path, "w") as f:
        f.write(text)
    return path
