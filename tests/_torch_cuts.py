"""Cuts of a config for the tests: ``cut_config(cfg, cut)`` replaces the
fields of ``cut``, a dotted name (``moe.n_experts``) a field of that
sub-config.  ``SOURCE`` is its source, for the subprocess scripts that
build a cut on either package's config."""

import dataclasses
import inspect


def cut_config(cfg, cut):
    top, sub = {}, {}
    for key, value in (cut or {}).items():
        if "." in key:
            name, field = key.split(".", 1)
            sub.setdefault(name, {})[field] = value
        else:
            top[key] = value
    for name, fields in sub.items():
        top[name] = dataclasses.replace(getattr(cfg, name), **fields)
    return dataclasses.replace(cfg, **top)


SOURCE = "import dataclasses\n" + inspect.getsource(cut_config)
