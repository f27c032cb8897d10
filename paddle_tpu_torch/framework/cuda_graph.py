"""Programs as CUDA graphs: the port's counterpart of a jitted program.

A `_Program` is a body over static input tensors; on the card it is
captured once as a ``torch.cuda.CUDAGraph`` and every call replays it,
reading its inputs and writing its outputs in place. On the CPU every
call runs the body eagerly over the same tensors. `_HostSets` stage a
program's inputs from pinned host buffers, `GraphSite` holds the memory
pool and the capture stream a family of programs shares, and
`GenerateProgram` runs a generation function (``jit_generate``'s
programs) as one captured program per signature.

The serving engine (``serving/engine.py``, which re-exports `_Program`
and `_HostSets`) and the generation entry points (``models/llama.py``)
both build on this module.
"""
from __future__ import annotations

import gc
from collections import namedtuple

import torch

from ..kernels import _build
from ..kernels.decode_attention import split_scratch_tensors

# one set of a program's host buffers (see _HostSets)
_HostSet = namedtuple("_HostSet", "inputs outputs event")


class _Program:
    """One program: `body(*inputs)` over static input tensors on one
    device, returning a tuple of output tensors.

    On the card `capture` runs the body once eagerly (which makes what its
    kernels create at their first launch, such as the split attention
    kernels' scratch) and then records it as a CUDA graph; every call
    replays the graph, which reads `inputs` and writes `outputs` in place.
    A replay calls no wrapper, so the launches the wrappers counted while
    the body was recorded are kept (`launches`) and added to the counters
    on every replay; the recording itself counts none. On the CPU there is
    no graph and every call runs the body eagerly over the same inputs. A
    failed capture or replay raises with the program's name: nothing runs
    eagerly in its place on the card.

    The capture runs over whatever the static inputs hold: its owner
    fills them with scratch rows first, so the eager warm-up touches
    nothing live. The warm-up's random draws (with a sampling `generator`)
    are taken back, so capturing a program never moves the stream that
    serving draws from."""

    def __init__(self, name: str, body, inputs, generator=None,
                 owner: str = "engine", site: "GraphSite" = None):
        self.name = name
        self.owner = owner
        self.body = body
        self.inputs = tuple(inputs)
        self.generator = generator      # the sampling generator, if any
        # the site the program is captured through (a site of its own by
        # default); its `graphed` switch says whether calls replay
        self.site = site if site is not None \
            else GraphSite(self.inputs[0].device)
        self.graph = None
        self.outputs = None
        self.launches = {}              # kernel -> launches in one replay
        self.captures = 0
        self._held = ()

    @property
    def graphed(self) -> bool:
        """Whether calls replay the graph (the site's switch); False runs
        the eager body, on the CPU always."""
        return self.site.graphed

    def capture(self, pool=None, stream=None):
        """Warm the body up eagerly, then (on the card) record it on
        `stream` into the memory pool `pool`."""
        if not self.graphed:
            self.outputs = self._keeping_generator(
                lambda: self.body(*self.inputs))
            self.captures += 1
            return
        self._keeping_generator(lambda: self._warm_up(stream))
        before = _build.launch_counts()
        try:
            graph, outputs = self._record(pool, stream)
        except RuntimeError as e:
            raise RuntimeError(f"capturing the {self.owner}'s {self.name} "
                               f"program as a CUDA graph failed: {e}") from e
        finally:
            counted = _build.launch_counts()
            _build.LAUNCHES.update(before)
        self.launches = {k: n - before[k] for k, n in counted.items()
                         if n != before[k]}
        self.graph, self.outputs = graph, outputs
        self._held = split_scratch_tensors(self.inputs[0].device)
        self.captures += 1

    def _keeping_generator(self, fn):
        """Run `fn` and put the sampling generator's state back: the
        eager warm-up must not draw from the stream serving uses. (A
        recording draws nothing; each replay advances the generator.)"""
        if self.generator is None:
            return fn()
        state = self.generator.get_state()
        try:
            return fn()
        finally:
            self.generator.set_state(state)

    def _warm_up(self, stream):
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            self.body(*self.inputs)

    def _record(self, pool, stream):
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            # replays advance the generator's offset, so every chunk draws
            # fresh numbers
            graph.register_generator_state(self.generator)
        # a graph the cyclic collector frees mid-capture (an engine dropped
        # earlier) would be destroyed inside this capture and invalidate
        # it: collect first, and hold the collector off until the end.
        # capture_begin / capture_end are torch.cuda.graph's without its
        # empty_cache() of the device and pinned host caches, which made
        # every capture of a warm() run of many programs refill them
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        torch.cuda.synchronize(stream.device)
        try:
            with torch.cuda.stream(stream):
                # "thread_local": only this thread's potentially unsafe
                # CUDA calls break the capture, so another thread of the
                # process (a watchdog-abandoned serving step blocked in a
                # readback wait) cannot invalidate it
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = self.body(*self.inputs)
                finally:
                    graph.capture_end()
        finally:
            if was_enabled:
                gc.enable()
        return graph, outputs

    def __call__(self):
        if not self.captures:
            raise RuntimeError(f"the {self.owner}'s {self.name} program was "
                               "never captured (warm() captures it)")
        if not self.graphed:
            self.outputs = self.body(*self.inputs)
            return self.outputs
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"replaying the {self.owner}'s {self.name} "
                               f"program failed: {e}") from e
        for name, n in self.launches.items():
            _build.LAUNCHES[name] += n
        return self.outputs


class GraphSite:
    """The memory pool and capture stream that a family of programs is
    captured through, made at the first capture on the card (after the
    kernels are built), and the family's one graph-or-eager switch:
    `graphed` (True on the card) makes every program of the site replay
    its graph; False runs their eager bodies on the card instead, the
    yardstick the graphs are held to. `captures` and `reserved_bytes`
    count the site's captures and the growth of the card's reserved
    memory across them (the eager warm-up's allocations included).

    Every graph of the family lands in the one pool, so a capture may
    take blocks that an earlier graph of the pool uses only inside its
    replay (its intermediates): a graph's outputs may then be overwritten
    by a later replay of a graph captured before it. Sharing is safe when
    the family's replays run one at a time on one stream (no two graphs
    of the pool are ever in flight together) and each replay's outputs are
    consumed, copied out or read by the next program in stream order,
    before another graph of the pool replays. A family whose outputs must
    outlive other programs' replays gets a site of its own."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graphed = device.type == "cuda"
        self.pool = None
        self.stream = None
        self.captures = 0
        self.reserved_bytes = 0

    def capture(self, prog: _Program) -> None:
        """Capture `prog` into this site's pool on its stream; the
        device's current stream then waits for the warm-up's work. A
        capture may come mid-traffic (a prefill key no warm() covered,
        with a double-buffered decode chunk in flight): the warm-up waits
        for the current stream's queued work, and the recording starts
        after a device synchronize."""
        cuda = self.device.type == "cuda"
        if cuda and self.pool is None:
            for name in _build.SIGNATURES:
                _build.library(name)
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        reserved = torch.cuda.memory_reserved(self.device) if cuda else 0
        prog.capture(self.pool, self.stream)
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        if cuda:
            self.reserved_bytes += \
                torch.cuda.memory_reserved(self.device) - reserved
        self.captures += 1


class _HostSets:
    """Host buffers of one program: two sets used in turn, each a mirror
    of `targets` (the device tensors dispatch copies into: the program's
    static inputs, plus any the engine adds) and of the program's outputs,
    pinned on the card and guarded by the event recorded after the set's
    copies. `take` waits for that event before handing a set out again, so
    the host never rewrites a buffer whose copy is still queued."""

    def __init__(self, targets, outputs):
        self.targets = tuple(targets)
        pin = self.targets[0].device.type == "cuda"

        def host(t):
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)

        self.sets = [_HostSet([host(t) for t in self.targets],
                              [host(t) for t in outputs],
                              torch.cuda.Event() if pin else None)
                     for _ in range(2)]
        self._turn = 0

    def take(self):
        hs = self.sets[self._turn]
        self._turn ^= 1
        if hs.event is not None:
            hs.event.synchronize()
        return hs

    def stage_in(self, arrays):
        """Write `arrays` into the next set and queue their copies into
        the targets. Returns the set."""
        hs = self.take()
        for buf, a, dst in zip(hs.inputs, arrays, self.targets):
            buf.numpy()[...] = a
            dst.copy_(buf, non_blocking=True)
        return hs

    @staticmethod
    def stage_out(hs, outputs):
        """Queue the copies of `outputs` into set `hs` and record its
        event."""
        for dst, src in zip(hs.outputs, outputs):
            dst.copy_(src, non_blocking=True)
        if hs.event is not None:
            hs.event.record()


class GenerateProgram:
    """A generation function `run(*weights, *inputs, generator,
    temperature, top_p) -> tokens` as ONE program (the counterpart of
    ``jax.jit(run)``): on the card a CUDA graph of the whole generation
    (prefill and every decode step), on the CPU its eager body.

    The static inputs are made as scratch (zeros; ones for the prompt
    lengths) at the first call, which captures over them; every call then
    copies its inputs in, reseeds the program's generator and replays.
    The weights are static too: the program reads the tensors of the call
    that captured it, and never writes them. Its owner hands every call
    the same tensors, and drops the program when they change (as
    ``jit_generate`` does when the model's weights are reloaded). The
    program captures through its owner's `site`, whose `graphed = False`
    runs the eager body on the card (the yardstick the graph is held
    to)."""

    def __init__(self, name: str, run, site: GraphSite,
                 do_sample: bool = False):
        self.name = name
        self.run = run
        self.site = site
        self.generator = torch.Generator(device=site.device)
        self._sampling = bool(do_sample)
        self.prog = None
        self.captures = 0
        self._weights = None

    def _capture(self, inputs) -> None:
        def scratch(t, i):
            # prompt lengths (the second input) must be >= 1
            return torch.ones_like(t) if i == 1 else torch.zeros_like(t)

        static = [scratch(t, i) for i, t in enumerate(inputs)]

        def body(*ins):
            with torch.no_grad():
                return (self.run(*self._weights, *ins[:-2], self.generator,
                                 ins[-2], ins[-1]),)

        self.prog = _Program(self.name, body, static,
                             self.generator if self._sampling else None,
                             owner="model", site=self.site)
        self.site.capture(self.prog)
        self.captures += 1

    def __call__(self, weights, inputs, seed: int, temperature: float,
                 top_p: float) -> torch.Tensor:
        """Tokens [b, max_new] of `run` over `weights` (a tuple of
        decode-params dicts, the same tensors every call) and `inputs`
        (tensors on the device)."""
        if self._weights is None:
            self._weights = tuple(weights)
        dev = self.site.device
        inputs = tuple(inputs) + (
            torch.tensor(float(temperature), dtype=torch.float32),
            torch.tensor(float(top_p), dtype=torch.float32))
        if self.prog is None or (self.site.graphed
                                 and self.prog.graph is None):
            self._capture([t.to(dev) for t in inputs])
        for dst, src in zip(self.prog.inputs, inputs):
            dst.copy_(src)
        self.generator.manual_seed(int(seed))
        return self.prog()[0].clone()
