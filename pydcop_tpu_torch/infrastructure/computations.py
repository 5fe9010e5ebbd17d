"""Message-passing computation base classes (a copy of
``pydcop_tpu/infrastructure/computations.py``; reference:
``pydcop/infrastructure/computations.py``).

Everything that runs on the host runtime is a
:class:`MessagePassingComputation`: it receives messages through
``on_message`` (dispatched to ``@register``-decorated handlers), and
sends through ``post_msg``, which the hosting agent/runtime wires to
its router.  Messages are :class:`SimpleRepr` objects, so the same
classes serialize for the cross-process orchestrator protocol.

This runtime exists for *async-semantics parity*: A-DSA / A-Max-Sum
are validated against these independent message-driven
implementations, while production solving runs on the batched engine.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from pydcop_tpu_torch.utils.simple_repr import _CLASS_KEY, _MODULE_KEY, SimpleRepr


class Message(SimpleRepr):
    """Base class for all messages exchanged between computations."""

    def __init__(self, msg_type: str, content: Any = None):
        self._msg_type = msg_type
        self._content = content

    @property
    def type(self) -> str:
        return self._msg_type

    @property
    def content(self) -> Any:
        return self._content

    @property
    def size(self) -> int:
        """Logical size used by the Messaging metrics (1 by default;
        subclasses override, e.g. a cost table counts its cells)."""
        return 1

    def __eq__(self, other):
        return (
            isinstance(other, Message)
            and self._msg_type == other._msg_type
            and self._content == other._content
        )

    def __hash__(self):
        return hash((self._msg_type, repr(self._content)))

    def __repr__(self) -> str:
        return f"Message({self._msg_type!r}, {self._content!r})"


def message_type(name: str, fields: List[str]):
    """Build a message dataclass-like subclass with named ``fields``
    (the reference's ``message_type`` factory).

    >>> ValueMsg = message_type("value", ["value"])
    >>> m = ValueMsg(value=3)
    >>> m.type, m.value
    ('value', 3)
    """

    def _init(self, *args, **kwargs):
        named = dict(zip(fields, args))
        overlap = set(named) & set(kwargs)
        if overlap:
            raise TypeError(f"duplicate argument(s): {sorted(overlap)}")
        named.update(kwargs)
        unknown = set(named) - set(fields)
        if unknown:
            raise TypeError(f"unknown field(s): {sorted(unknown)}")
        missing = set(fields) - set(named)
        if missing:
            raise TypeError(f"missing field(s): {sorted(missing)}")
        Message.__init__(self, name, dict(named))

    def _getter(field):
        return property(lambda self: self._content[field])

    def _simple_repr(self):
        from pydcop_tpu_torch.utils.simple_repr import simple_repr

        return {
            _CLASS_KEY: type(self).__qualname__,
            _MODULE_KEY: type(self).__module__,
            "fields": simple_repr(self._content),
        }

    @classmethod
    def _from_repr(cls, r):
        from pydcop_tpu_torch.utils.simple_repr import from_repr

        return cls(**from_repr(r["fields"]))

    namespace: Dict[str, Any] = {
        "__init__": _init,
        "_simple_repr": _simple_repr,
        "_from_repr": _from_repr,
    }
    for f in fields:
        namespace[f] = _getter(f)
    cls = type(f"{name.capitalize()}Message", (Message,), namespace)
    return cls


def stable_seed(seed: int, name: str) -> int:
    """Mix a run seed with a computation name, stably across processes
    (``hash()`` is salted per interpreter; crc32 is not)."""
    import zlib

    return (seed * 0x9E3779B1) ^ zlib.crc32(name.encode())


def register(msg_type: str):
    """Decorator marking a method as the handler for ``msg_type``."""

    def deco(fn: Callable):
        fn._handles_msg_type = msg_type
        return fn

    return deco


class MessagePassingComputation:
    """A named computation driven entirely by messages.

    The hosting runtime assigns ``message_sender`` (a callable
    ``(src_comp, dest_comp, msg) -> None``) before ``start()``.
    Handlers are declared with ``@register("msg-type")``; ``footprint``
    is the memory estimate the distribution layer uses.
    """

    def __init__(self, name: str):
        self._name = name
        self._running = False
        self._started = False
        # algorithm messages that arrive before start(): a peer whose
        # start raced ahead may legitimately send first (the
        # cross-process runtimes broadcast 'start' sequentially) —
        # buffered and replayed instead of dropped
        self._pre_start: List[Tuple[str, Message, float]] = []
        self.message_sender: Optional[Callable[[str, str, Message], None]] = None
        # collect @register handlers from the class hierarchy
        self._handlers: Dict[str, Callable] = {}
        for klass in reversed(type(self).__mro__):
            for attr in vars(klass).values():
                mt = getattr(attr, "_handles_msg_type", None)
                if mt is not None:
                    self._handlers[mt] = attr

    @property
    def name(self) -> str:
        return self._name

    @property
    def is_running(self) -> bool:
        return self._running

    def start(self) -> None:
        """Enter the running state, fire ``on_start``, then replay any
        messages that arrived before the start."""
        self._running = True
        self._started = True
        self.on_start()
        buffered, self._pre_start = self._pre_start, []
        for sender, msg, t in buffered:
            self.on_message(sender, msg, t)

    def stop(self) -> None:
        self._running = False
        self.on_stop()

    def on_start(self) -> None:  # override point
        pass

    def on_stop(self) -> None:  # override point
        pass

    def post_msg(self, target: str, msg: Message) -> None:
        if self.message_sender is None:
            raise RuntimeError(
                f"Computation {self._name} is not attached to a runtime"
            )
        self.message_sender(self._name, target, msg)

    def on_message(self, sender: str, msg: Message, t: float = 0.0) -> None:
        """Dispatch one message to its ``@register``-ed handler."""
        if not self._running:
            if not self._started:  # early message: replayed by start()
                self._pre_start.append((sender, msg, t))
            return  # stopped: late messages are dropped
        handler = self._handlers.get(msg.type)
        if handler is None:
            raise ValueError(
                f"Computation {self._name} has no handler for message "
                f"type {msg.type!r} (handlers: {sorted(self._handlers)})"
            )
        handler(self, sender, msg, t)

    def footprint(self) -> float:
        return 1.0

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._name!r})"


class DcopComputation(MessagePassingComputation):
    """A computation attached to a computation-graph node: knows its
    neighbors and its algorithm-estimated footprint."""

    def __init__(self, name: str, comp_def):
        super().__init__(name)
        self.computation_def = comp_def
        self._neighbors: List[str] = (
            list(comp_def.node.neighbors) if comp_def is not None else []
        )

    @property
    def neighbors(self) -> List[str]:
        return self._neighbors

    def post_to_all_neighbors(self, msg: Message) -> None:
        for n in self._neighbors:
            self.post_msg(n, msg)

    # -- resilience hook (replica migration, hostnet k_target) --------
    #
    # When a neighboring computation dies with its agent and is
    # re-deployed on a replica holder, the fresh instance knows
    # nothing this computation ever told it.  The runtime posts a
    # ``_peer_restarted`` message (through the normal pump, so the
    # hook runs on the computation thread like any handler) and
    # algorithms override :meth:`on_peer_restarted` to re-send their
    # current view to that one peer.  Default: no-op — an algorithm
    # without the override still works, it just relies on its own
    # periodic traffic to re-sync the migrated neighbor.

    @register("_peer_restarted")
    def _on_peer_restarted_msg(
        self, sender: str, msg: Message, t: float
    ) -> None:
        self.on_peer_restarted(msg.content)

    def on_peer_restarted(self, peer: str) -> None:  # override point
        pass

    def footprint(self) -> float:
        if self.computation_def is None:
            return 1.0
        from pydcop_tpu_torch.algorithms import load_algorithm_module

        module = load_algorithm_module(self.computation_def.algo.algo)
        return module.computation_memory(self.computation_def.node)


class VariableComputation(DcopComputation):
    """A computation that owns one decision variable and selects values
    for it (reference: ``VariableComputation.value_selection``)."""

    def __init__(self, variable, comp_def):
        super().__init__(variable.name, comp_def)
        self._variable = variable
        self.current_value: Any = None
        self.value_history: List[Any] = []
        # replica migration (hostnet k_target): the runtime sets this
        # BEFORE start() to the variable's last orchestrator-sampled
        # value, so a migrated computation resumes from the
        # pre-failure assignment instead of a fresh random draw.
        # Algorithms honor it in on_start where an initial draw exists.
        self.restart_value: Any = None

    def initial_value_or(self, default_fn) -> Any:
        """``restart_value`` when set and in-domain, else
        ``default_fn()`` — the one-line way for an algorithm's
        ``on_start`` to support migration restarts."""
        rv = self.restart_value
        if rv is not None and rv in self._variable.domain:
            return rv
        return default_fn()

    @property
    def variable(self):
        return self._variable

    def value_selection(self, value: Any) -> None:
        if value != self.current_value:
            self.current_value = value
            self.value_history.append(value)

    def random_value(self, rnd) -> Any:
        return self._variable.domain[rnd.randrange(len(self._variable.domain))]
