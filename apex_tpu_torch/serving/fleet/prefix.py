"""Shared-prefix radix index over block tables: prefix-aware placement.

A serving fleet without placement affinity wastes its KV caches: two
requests sharing a long prompt prefix (the system-prompt shape) land on
different replicas and each pays the full prefill, even though the
first replica already holds the shared blocks. The index here is the
routing half of prefix caching (the vLLM/SGLang radix-tree idea at
BLOCK granularity): a radix tree whose edges are ``block_size``-token
chunks of past prompts, each node remembering WHICH replica last
prefilled that prefix. Placement looks up the longest indexed prefix of
a new prompt and routes to the remembering replica; the matched token
count is the request's **prefix-cache hit**, emitted on its
``kind="request"`` records (``prefix_hit_tokens``/``prefix_hit_rate``
tags) so hit rates are a stream query, not a private counter.

Block granularity is deliberate: the engine's KV pool is allocated and
handed off in blocks (kvcache.py), so a sub-block prefix match could
never be reused anyway — indexing finer would report hits the cache
cannot serve.

Bounded like every fleet structure: ``max_nodes`` caps the tree and
eviction is least-recently-touched-leaf-first, so a long-tailed prompt
distribution cannot grow the router's memory without limit.
``evict_replica`` drops a dead/drained replica's claims (its pool is
gone — routing affinity to a corpse would be worse than no affinity).

Copied from apex_tpu/serving/fleet/prefix.py, which imports no JAX.
"""

from typing import Dict, List, Optional, Tuple

__all__ = ["RadixPrefixIndex"]


class _Node:
    __slots__ = ("children", "replica", "stamp")

    def __init__(self):
        #: chunk (tuple of block_size token ints) -> child node
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        #: replica that last prefilled the prefix ending here
        self.replica: Optional[str] = None
        self.stamp: int = 0


class RadixPrefixIndex:
    """The fleet router's shared-prefix radix index (module docstring).

    ``insert(tokens, replica)`` records that ``replica`` now holds the
    prompt's full-block prefixes; ``lookup(tokens)`` returns
    ``(replica, matched_tokens)`` for the longest indexed prefix whose
    remembering replica is still admissible (``live`` filter), with
    ``(None, 0)`` on a cold miss.
    """

    def __init__(self, block_size: int, max_nodes: int = 4096):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_nodes < 1:
            raise ValueError(f"max_nodes must be >= 1, got {max_nodes}")
        self.block_size = int(block_size)
        self.max_nodes = int(max_nodes)
        self._root = _Node()
        self._n_nodes = 0
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0

    def _chunks(self, tokens) -> List[Tuple[int, ...]]:
        toks = [int(t) for t in tokens]
        bs = self.block_size
        return [
            tuple(toks[i:i + bs])
            for i in range(0, len(toks) - len(toks) % bs, bs)
        ]

    def insert(self, tokens, replica: str) -> int:
        """Claim every full-block prefix of ``tokens`` for ``replica``;
        returns the number of chunks indexed."""
        self._clock += 1
        node = self._root
        chunks = self._chunks(tokens)
        for chunk in chunks:
            child = node.children.get(chunk)
            if child is None:
                child = _Node()
                node.children[chunk] = child
                self._n_nodes += 1
            child.replica = str(replica)
            child.stamp = self._clock
            node = child
        if self._n_nodes > self.max_nodes:
            self._evict_lru()
        return len(chunks)

    def lookup(self, tokens, live=None) -> Tuple[Optional[str], int]:
        """``(replica, matched_tokens)`` of the longest indexed prefix
        held by an admissible replica (``live``: an optional container
        of admissible names; claims outside it are skipped, matched
        length still counts only what that replica holds)."""
        self._clock += 1
        self.lookups += 1
        self.lookup_tokens += len(tokens)
        node = self._root
        best: Tuple[Optional[str], int] = (None, 0)
        depth = 0
        for chunk in self._chunks(tokens):
            node = node.children.get(chunk)
            if node is None:
                break
            depth += 1
            node.stamp = self._clock
            if node.replica is not None and (
                    live is None or node.replica in live):
                best = (node.replica, depth * self.block_size)
        if best[0] is not None:
            self.hits += 1
            self.hit_tokens += best[1]
        return best

    def evict_replica(self, replica: str) -> int:
        """Drop every claim held by ``replica`` (killed or drained —
        its pool no longer exists); returns the claims cleared. Nodes
        stay (a child chain may still be claimed by others) and age out
        through the LRU bound."""
        cleared = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.replica == replica:
                    child.replica = None
                    cleared += 1
                stack.append(child)
        return cleared

    def _evict_lru(self) -> None:
        """Prune least-recently-touched LEAVES until back under the
        bound (leaf-first keeps every surviving prefix reachable)."""
        while self._n_nodes > self.max_nodes:
            oldest: Optional[Tuple[int, _Node, Tuple[int, ...]]] = None
            stack = [self._root]
            while stack:
                node = stack.pop()
                for key, child in node.children.items():
                    if child.children:
                        stack.append(child)
                    elif oldest is None or child.stamp < oldest[0]:
                        oldest = (child.stamp, node, key)
            if oldest is None:  # pragma: no cover - root-only tree
                return
            del oldest[1].children[oldest[2]]
            self._n_nodes -= 1

    def stats(self) -> dict:
        """Aggregate hit accounting (the fleet ``stats()`` block)."""
        return {
            "nodes": self._n_nodes,
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": (self.hits / self.lookups) if self.lookups else 0.0,
            "hit_tokens": self.hit_tokens,
            "token_hit_rate": (
                self.hit_tokens / self.lookup_tokens
                if self.lookup_tokens else 0.0
            ),
        }
