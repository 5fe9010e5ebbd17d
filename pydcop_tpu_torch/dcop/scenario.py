"""Timed event scenarios for dynamic DCOP runs.

Role-equivalent to ``pydcop/dcop/scenario.py``: a scenario is an ordered
list of events; an event is either a delay or a list of actions (remove /
add an agent, set an external variable's value).  The orchestrator (host
control plane) replays them during ``run``; on the TPU engine an agent
removal becomes masking the agent's variables out of the batched state
plus a host-side repair step.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from pydcop_tpu_torch.utils.simple_repr import SimpleRepr


class EventAction(SimpleRepr):
    """A single action: ``type`` in {'add_agent', 'remove_agent',
    'set_value'} with free-form string parameters."""

    def __init__(self, type: str, **args: Any):  # noqa: A002 — reference API
        self._type = type
        self._args = {k: str(v) for k, v in args.items()}

    @property
    def type(self) -> str:
        return self._type

    @property
    def args(self) -> Dict[str, str]:
        return dict(self._args)

    def __repr__(self) -> str:
        return f"EventAction({self._type!r}, {self._args})"

    def __eq__(self, other):
        return (
            isinstance(other, EventAction)
            and other._type == self._type
            and other._args == self._args
        )

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY

        r = {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "type": self._type,
        }
        r.update(self._args)
        return r

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY

        args = {
            k: v for k, v in r.items() if k not in (_CLASS_KEY, _MODULE_KEY, "type")
        }
        return cls(r["type"], **args)


class ScenarioEvent(SimpleRepr):
    """Either a delay (seconds or rounds) or a list of actions."""

    def __init__(
        self,
        id: str = "",  # noqa: A002 — reference API
        delay: Optional[float] = None,
        actions: Optional[List[EventAction]] = None,
    ):
        if (delay is None) == (actions is None):
            raise ValueError("An event is either a delay or a list of actions")
        if actions is not None and not actions:
            raise ValueError("An action event needs at least one action")
        self._id = id
        self._delay = delay
        self._actions = list(actions) if actions is not None else None

    @property
    def id(self) -> str:
        return self._id

    @property
    def is_delay(self) -> bool:
        return self._delay is not None

    @property
    def delay(self) -> Optional[float]:
        return self._delay

    @property
    def actions(self) -> Optional[List[EventAction]]:
        return list(self._actions) if self._actions else None

    def __repr__(self) -> str:
        if self.is_delay:
            return f"ScenarioEvent(delay={self._delay})"
        return f"ScenarioEvent({self._id!r}, actions={self._actions})"

    def __eq__(self, other):
        return (
            isinstance(other, ScenarioEvent)
            and other._id == self._id
            and other._delay == self._delay
            and other._actions == self._actions
        )

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        r = {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "id": self._id,
        }
        if self._delay is not None:
            r["delay"] = self._delay
        else:
            r["actions"] = [simple_repr(a) for a in self._actions]
        return r

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        if "delay" in r:
            return cls(r.get("id", ""), delay=r["delay"])
        return cls(
            r.get("id", ""),
            actions=[from_repr(a) for a in r["actions"]],
        )


class Scenario(SimpleRepr):
    """An ordered list of scenario events."""

    def __init__(self, events: Optional[Iterable[ScenarioEvent]] = None):
        self._events = list(events) if events else []

    @property
    def events(self) -> List[ScenarioEvent]:
        return list(self._events)

    def append(self, event: ScenarioEvent) -> None:
        self._events.append(event)

    def __iter__(self):
        return iter(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def __eq__(self, other):
        return isinstance(other, Scenario) and other._events == self._events

    def _simple_repr(self) -> dict:
        from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, simple_repr

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "events": [simple_repr(e) for e in self._events],
        }

    @classmethod
    def _from_repr(cls, r: dict):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        return cls([from_repr(e) for e in r["events"]])
