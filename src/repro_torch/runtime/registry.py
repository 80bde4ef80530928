"""Executor backend registry.

New runtime backends plug into the agent without editing ``agent.py``:

    from repro_torch.runtime.registry import register_executor

    @register_executor("mybackend", mode="sim")
    def build(engine, nodes, spec, **options):
        return MyExecutor(engine, nodes, spec, **options)

``Agent._build_backends`` resolves ``{"mybackend": {...options}}`` through
:func:`create_executor`, keyed on the engine's ``mode`` ("sim" / "real");
a factory registered under ``mode="any"`` serves both. Built-in backends
(sim: flux/dragon/srun/funcpool; real: flux/dragon/popen/funcpool)
self-register on import.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

ExecutorFactory = Callable[..., object]

_REGISTRY: Dict[Tuple[str, str], ExecutorFactory] = {}
_builtins_loaded = False


def register_executor(name: str, mode: str = "sim"
                      ) -> Callable[[ExecutorFactory], ExecutorFactory]:
    """Decorator registering ``factory(engine, nodes, spec, **options)``
    as the constructor for backend ``name`` under engine ``mode``."""
    def deco(factory: ExecutorFactory) -> ExecutorFactory:
        _REGISTRY[(mode, name)] = factory
        return factory
    return deco


def unregister_executor(name: str, mode: str = "sim"):
    _REGISTRY.pop((mode, name), None)


def _ensure_builtins():
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    # importing the modules triggers their @register_executor decorators
    import repro_torch.core.executors.dragon    # noqa: F401
    import repro_torch.core.executors.flux      # noqa: F401
    import repro_torch.core.executors.funcpool  # noqa: F401
    import repro_torch.core.executors.srun      # noqa: F401
    import repro_torch.runtime.real_executors   # noqa: F401


def available_executors(mode: str) -> List[str]:
    _ensure_builtins()
    return sorted({n for m, n in _REGISTRY if m in (mode, "any")})


def create_executor(name: str, engine, nodes: int, spec, **options):
    """Build backend ``name`` for ``engine`` (dispatch on ``engine.mode``)."""
    _ensure_builtins()
    factory = (_REGISTRY.get((engine.mode, name))
               or _REGISTRY.get(("any", name)))
    if factory is None:
        raise KeyError(
            f"no executor {name!r} registered for mode {engine.mode!r} "
            f"(available: {available_executors(engine.mode)})")
    return factory(engine, nodes=nodes, spec=spec, **options)
