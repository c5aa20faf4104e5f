"""Probes: wrappers the traced run puts around calls into the program's
layers.  Each ``probes/<name>.py`` has ``install(record)``, which wraps
its calls, appends what it measures to ``record``, and returns a
function that takes the wrappers off.  A per-layer metric's reader names
the probes it reads in ``PROBES``."""

from __future__ import annotations

from .. import spec as spec_mod


def install(per_layer: list, record: dict, root=spec_mod.ROOT):
    names = []
    for m in per_layer:
        for p in getattr(spec_mod.reader(m["name"], root), "PROBES", ()):
            if p not in names:
                names.append(p)
    undo = [spec_mod.load_module(root / "fembench" / "probes" / f"{p}.py")
            .install(record) for p in names]

    def uninstall():
        for u in reversed(undo):
            u()

    return uninstall


def wrap_method(cls, name, make):
    """Replace ``cls.name`` by ``make(original)``; returns the undo."""
    original = getattr(cls, name)
    setattr(cls, name, make(original))
    return lambda: setattr(cls, name, original)
