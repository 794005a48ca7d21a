"""Reference `.conf` file compatibility layer — the port's copy of the JAX
package's `utils/conf.py`, over the port's `Config`.

Parses the reference's two mini-formats so its 40 `conf/*.conf` files
can drive this framework directly:
  * `ModelConf` — `key=value` lines (util/conf.py:10-35);
  * `OptionConf` — `-flag value` substrings (util/conf.py:37-74), e.g.
    `LightGCN=-n_layer 2` or `item.ranking=-topN 10,20`.
`config_from_conf` maps the reference keys onto the typed Config.
"""

from __future__ import annotations

import os

from ..core.config import Config, make_config


class ModelConf:
    def __init__(self, path: str):
        self.config: dict[str, str] = {}
        if not os.path.exists(path):
            raise IOError(f"config file not found: {path}")
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or "=" not in line:
                    continue
                key, value = line.split("=", 1)
                self.config[key.strip()] = value.strip()

    def __getitem__(self, key: str) -> str:
        return self.config[key]

    def contain(self, key: str) -> bool:
        return key in self.config


class OptionConf:
    def __init__(self, content: str):
        parts = content.strip().split(" ")
        self.options: dict[str, str] = {}
        i = 0
        while i < len(parts):
            if parts[i].startswith("-"):
                val = parts[i + 1] if i + 1 < len(parts) else ""
                self.options[parts[i]] = val
                i += 2
            else:
                i += 1

    def __getitem__(self, flag: str) -> str:
        return self.options[flag]

    def contain(self, flag: str) -> bool:
        return flag in self.options


# reference conf key -> (Config field, caster)
_KEY_MAP = {
    "model.name": ("model", str),
    "dataset": ("dataset", str),
    "embedding.size": ("embedding_size", int),
    "input.size": ("input_dim", int),
    "num.max.epoch": ("max_epoch", int),
    "batch_size": ("batch_size", int),
    "batch_size_kg": ("batch_size_kg", int),
    "learnRate": ("lrate", float),
    "learnRateDecay": ("lr_decay", float),
    "reg.lambda": ("reg", float),
    "hyper.size": ("hyper_dim", int),
    "hyperedge_num": ("hyperedge_num", int),
    "gnn_layer": ("n_layers", int),
    "num_layers": ("n_layers", int),
    "leaky": ("p", float),
    "temp": ("temp", float),
    "ss_rate": ("cl_rate", float),
    "dropout": ("drop_rate", float),
    "use.knowledge": ("use_knowledge", lambda v: v.lower() == "true"),
    "training.set": ("training_set", str),
    "test.set": ("test_set", str),
    "knowledge.data": ("knowledge_file", str),
}


def config_from_conf(path: str, **overrides) -> Config:
    """Build a typed Config from a reference-format .conf file.

    CLI-style overrides win over conf values, matching the reference's
    precedence (models read kwargs over conf — survey 2.10)."""
    mc = ModelConf(path)
    kwargs: dict = {}
    for key, (field, cast) in _KEY_MAP.items():
        if mc.contain(key):
            try:
                kwargs[field] = cast(mc[key])
            except ValueError:
                pass
    if mc.contain("item.ranking"):
        oc = OptionConf(mc["item.ranking"])
        if oc.contain("-topN"):
            kwargs["item_ranking"] = tuple(int(x) for x in oc["-topN"].split(","))
    model = kwargs.pop("model", None)
    kwargs.update(overrides)
    return make_config(model, **kwargs)
