"""Typed config base (port of ``deepspeed_tpu/runtime/config_utils.py``).

The JAX package builds its configs on pydantic; the port's target machine
has no pydantic, so the base is a plain dataclass with the same three
behaviours: unknown keys are kept as attributes (pydantic's
``extra="allow"``), deprecated aliases resolve to their field, and a
nested config block may be given as a dict.

Subclasses are ``@dataclasses.dataclass(init=False)`` classes that list
their aliases in ``_aliases`` and may define ``validate()``.
"""

import dataclasses
import json
from typing import ClassVar, Dict


class DeepSpeedConfigModel:
    _aliases: ClassVar[Dict[str, str]] = {}

    def __init__(self, **kwargs):
        for alias, name in self._aliases.items():
            if alias in kwargs:
                if name in kwargs:
                    raise ValueError(f"{type(self).__name__}: both {name!r} "
                                     f"and its alias {alias!r} given")
                kwargs[name] = kwargs.pop(alias)
        for f in dataclasses.fields(self):
            if f.name in kwargs:
                value = kwargs.pop(f.name)
                sub = f.default_factory
                if isinstance(value, dict) and isinstance(sub, type) \
                        and issubclass(sub, DeepSpeedConfigModel):
                    value = sub(**value)
            elif f.default_factory is not dataclasses.MISSING:
                value = f.default_factory()
            elif f.default is not dataclasses.MISSING:
                value = f.default
            else:
                raise TypeError(f"{type(self).__name__}: missing {f.name!r}")
            setattr(self, f.name, value)
        self._extra = dict(kwargs)
        for key, value in kwargs.items():
            setattr(self, key, value)
        self.validate()

    def validate(self):
        """Hook for cross-field checks; runs at the end of ``__init__``."""

    def to_dict(self):
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            out[f.name] = value.to_dict() \
                if isinstance(value, DeepSpeedConfigModel) else value
        out.update(self._extra)
        return out

    def dump(self):
        return json.dumps(self.to_dict(), indent=2, default=str)
