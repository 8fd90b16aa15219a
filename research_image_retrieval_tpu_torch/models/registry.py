"""Model registry: name -> (constructor, preset config, metadata)
(port of ``research_image_retrieval_tpu/models/registry.py``).

``get_model`` takes a registry name or a Table-1 paper name
(``"R101-DOLG"``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = ["MODEL_REGISTRY", "TABLE1_TO_MODEL_MAPPING", "get_model",
           "get_model_info", "list_available_models", "register_model"]


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    builder: Callable[..., Any]
    description: str
    defaults: dict
    family: str = ""
    paper: str = ""


MODEL_REGISTRY: dict[str, ModelEntry] = {}

# Table-1 paper name -> registry name
TABLE1_TO_MODEL_MAPPING: dict[str, str] = {}


def register_model(name: str, *, description: str = "",
                   defaults: dict | None = None, family: str = "",
                   paper: str = "", table1_names: tuple = ()):
    """Decorator registering a model builder under ``name`` (and its
    Table-1 names)."""

    def deco(builder):
        MODEL_REGISTRY[name] = ModelEntry(name, builder, description,
                                          dict(defaults or {}), family, paper)
        for t1 in table1_names:
            TABLE1_TO_MODEL_MAPPING[t1] = name
        return builder

    return deco


def _entry(name: str) -> ModelEntry:
    key = TABLE1_TO_MODEL_MAPPING.get(name, name)
    if key not in MODEL_REGISTRY:
        raise KeyError(f"Unknown model '{name}'. "
                       f"Available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[key]


def get_model(name: str, **overrides):
    """Build a model by registry (or Table-1) name; ``overrides`` update
    its preset."""
    entry = _entry(name)
    return entry.builder(**{**entry.defaults, **overrides})


def list_available_models() -> list[str]:
    return sorted(MODEL_REGISTRY)


def get_model_info(name: str) -> dict:
    e = _entry(name)
    return {"name": e.name, "description": e.description,
            "defaults": dict(e.defaults), "family": e.family,
            "paper": e.paper}
