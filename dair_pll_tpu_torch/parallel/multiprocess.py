r"""Multi-process scale-out over ``torch.distributed``, and cross-process
trial coordination.

Counterpart of ``dair_pll_tpu/parallel/multiprocess.py``:

* :func:`initialize` — ``torch.distributed.init_process_group`` over
  ``tcp://`` (the counterpart of ``jax.distributed.initialize``): one
  process per card, as ``torchrun`` starts them; it also sets the rank's
  card. Afterwards ``parallel/sharding.py``'s meshes span the processes.
* :func:`global_batch` — the counterpart of
  ``jax.make_array_from_process_local_data``. PyTorch has no global array
  object: each rank keeps only its local rows, and the data-parallel step
  and rollout (``parallel/sharding.py``) work on those.
* :class:`TrialCoordinatorServer`, :class:`TcpTrialCoordinator` and
  :class:`FileTrialCoordinator` — cross-process study-trial dispatch over
  TCP or a shared filesystem (the role of the reference's shared optuna
  RDB, ``/root/reference/dair_pll/study.py:134-148``), a copy of the JAX
  package's, which imports no JAX.
"""
from __future__ import annotations

import hmac
import json
import os
import secrets
import socket
import socketserver
import threading
import time
import uuid
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

#: Default staleness window after which a claimed-but-unpublished trial
#: may be re-claimed by another worker (a crashed worker would otherwise
#: orphan its trials and block ``gather_results`` until its timeout).
#: Trials are coarse (minutes each); one hour is comfortably past any
#: healthy trial while still unblocking a study within the same session.
DEFAULT_CLAIM_TTL_S = 3600.0


def initialize(coordinator_address: str, num_processes: int,
               process_id: int,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None,
               timeout_s: float = 600.0,
               device: Optional[str] = None):
    """Joins this process to the default process group.

    Call once per process, before any collective. ``coordinator_address``
    is ``host:port`` of rank 0 (``torchrun``'s ``MASTER_ADDR`` and
    ``MASTER_PORT``). ``device`` ``None`` means a CUDA card and raises
    when none is present; the CPU is used only when the caller passes
    ``device="cpu"``. The rank's card is ``local_device_ids[0]``, or
    ``process_id`` modulo the cards visible. ``backend`` is ``"nccl"`` on
    a card and ``"gloo"`` on the CPU by default (gloo also takes CUDA
    tensors, which lets several processes share one card). Returns the
    rank's device."""
    import datetime

    import torch
    import torch.distributed as dist
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        index = device.index
        if index is None:
            index = (local_device_ids[0] if local_device_ids else
                     process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def initialize_from_env(device: Optional[str] = None):
    """Joins the process group that ``torchrun`` describes in the
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``) when ``WORLD_SIZE`` is above 1 and no group
    exists yet, on ``device`` as :func:`initialize` takes it; returns the
    rank's device, or ``None`` (nothing to join)."""
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or (dist.is_available() and dist.is_initialized()):
        return None
    address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
               f"{os.environ['MASTER_PORT']}")
    local = os.environ.get("LOCAL_RANK")
    return initialize(address, world, int(os.environ["RANK"]),
                      None if local is None else [int(local)],
                      device=device)


def global_batch(local_batch: Any) -> Any:
    """This rank's rows of a batch, as they are: PyTorch has no global
    array object (``jax.make_array_from_process_local_data`` builds one
    from every process's rows). The data-parallel step and rollout of
    ``parallel/sharding.py`` take each rank's rows, or the whole batch on
    every rank, and gather what they return with collectives."""
    return local_batch


class TrialCoordinatorServer:
    """Tiny in-memory TCP trial-state server (JSON-lines protocol).

    The genuinely cross-host analogue of the reference's shared optuna
    RDB server (``/root/reference/dair_pll/study.py:134-148``,
    ``OPTUNA_SERVER``): one process runs the server, every study worker
    (on any machine that can reach ``host:port``) connects with
    :class:`TcpTrialCoordinator` and races to claim trial indices.
    State is a claim set and a result dict guarded by one lock — trials
    are coarse (minutes each), so a threaded JSON-line server is far
    below any contention scale that would matter.

    Protocol (one JSON object per line, one reply per request; every
    request must carry the server's shared ``token``)::

        {"op": "claim",   "round": r, "trial": t, "token": s} -> {"ok": bool}
        {"op": "publish", "round": r, "trial": t, "token": s,
         "payload": {...}}                                    -> {"ok": true}
        {"op": "fetch",   "round": r, "trials": [t, ...],
         "token": s}                                          ->
            {"results": {"t": payload, ...}}   # only finished ones
        {"op": "ping", "token": s}                            -> {"ok": true}

    Security: the server binds ``127.0.0.1`` by default (pass an explicit
    ``host`` — e.g. ``"0.0.0.0"`` — to opt in to external connections)
    and authenticates every request against a shared random ``token``
    (auto-generated unless provided), so a network peer cannot claim
    trials or publish forged results that would steer hyperparameter
    selection. Distribute :attr:`address` (which embeds the token as
    ``host:port?token=...``) to workers over a trusted channel.

    Liveness: a claim expires after ``claim_ttl_s`` seconds unless its
    result is published, after which another worker may re-claim the
    trial — a crashed worker no longer orphans its trials for the whole
    ``gather_results`` timeout.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 token: Optional[str] = None,
                 advertise_host: Optional[str] = None,
                 claim_ttl_s: float = DEFAULT_CLAIM_TTL_S) -> None:
        self._lock = threading.Lock()
        #: claim key -> lease expiry (monotonic seconds).
        self._claims: Dict[Tuple[int, int], float] = {}
        self._results: Dict[Tuple[int, int], dict] = {}
        self.token = token if token is not None else secrets.token_hex(16)
        self.claim_ttl_s = float(claim_ttl_s)
        self._advertise_host = advertise_host
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                for raw in self.rfile:
                    line = raw.strip()
                    if not line:
                        continue
                    try:
                        reply = outer._dispatch(json.loads(line))
                    except Exception as error:  # malformed request
                        reply = {"ok": False, "error": str(error)}
                    self.wfile.write(
                        (json.dumps(reply) + "\n").encode())
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        """Connectable ``host:port?token=...`` string for workers.

        The host part is a REACHABLE address: the configured
        ``advertise_host`` when given, the bind host when it is a real
        interface, or this machine's hostname when bound to a wildcard
        address (``0.0.0.0``/``::`` are bind-only and not connectable
        from other hosts)."""
        host, port = self._server.server_address[:2]
        if self._advertise_host:
            host = self._advertise_host
        elif host in ("0.0.0.0", "::", ""):
            host = socket.getfqdn() or socket.gethostname()
        return f"{host}:{port}?token={self.token}"

    def _dispatch(self, request: dict) -> dict:
        supplied = str(request.get("token", ""))
        if not hmac.compare_digest(supplied, self.token):
            return {"ok": False, "error": "bad token"}
        op = request.get("op")
        if op == "ping":
            return {"ok": True}
        if op == "claim":
            key = (int(request["round"]), int(request["trial"]))
            now = time.monotonic()
            with self._lock:
                if key in self._results:
                    return {"ok": False}
                expiry = self._claims.get(key)
                if expiry is not None and now < expiry:
                    return {"ok": False}
                # Unclaimed, or the lease of a crashed worker expired.
                self._claims[key] = now + self.claim_ttl_s
            return {"ok": True}
        if op == "publish":
            key = (int(request["round"]), int(request["trial"]))
            with self._lock:
                self._results[key] = request["payload"]
            return {"ok": True}
        if op == "fetch":
            round_index = int(request["round"])
            with self._lock:
                results = {
                    str(trial): self._results[(round_index, int(trial))]
                    for trial in request["trials"]
                    if (round_index, int(trial)) in self._results}
            return {"results": results}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def start(self) -> str:
        """Starts serving on a daemon thread; returns ``host:port``."""
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self.address

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class TcpTrialCoordinator:
    """Client for :class:`TrialCoordinatorServer` with the same duck-typed
    API as :class:`FileTrialCoordinator` (``try_claim`` /
    ``publish_result`` / ``gather_results`` / ``claim_iter``), so
    ``Study.optimize_hyperparameters`` works across machines without a
    shared filesystem.

    ``address`` is the server's :attr:`TrialCoordinatorServer.address`
    string — ``host:port?token=...``; the shared token may instead be
    passed explicitly via ``token``."""

    def __init__(self, address: str, timeout_s: float = 30.0,
                 token: Optional[str] = None) -> None:
        address, _, query = address.partition("?")
        if query.startswith("token="):
            token = query[len("token="):]
        host, _, port = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.timeout_s = timeout_s
        self.token = token or ""

    def _rpc(self, request: dict) -> dict:
        request = dict(request, token=self.token)
        with socket.create_connection((self.host, self.port),
                                      timeout=self.timeout_s) as conn:
            conn.sendall((json.dumps(request) + "\n").encode())
            with conn.makefile("r", encoding="utf-8") as reader:
                line = reader.readline()
        if not line:
            raise ConnectionError(
                f"trial coordinator at {self.host}:{self.port} closed "
                "the connection")
        reply = json.loads(line)
        if reply.get("error") == "bad token":
            raise PermissionError(
                f"trial coordinator at {self.host}:{self.port} rejected "
                "the shared token; pass the server's full .address "
                "string (host:port?token=...)")
        return reply

    def try_claim(self, round_index: int, trial_index: int) -> bool:
        return bool(self._rpc({"op": "claim", "round": round_index,
                               "trial": trial_index})["ok"])

    def claim_iter(self, round_index: int,
                   trial_indices: Sequence[int]) -> Iterator[int]:
        for index in trial_indices:
            if self.try_claim(round_index, index):
                yield index

    def publish_result(self, round_index: int, trial_index: int,
                       payload: dict) -> None:
        self._rpc({"op": "publish", "round": round_index,
                   "trial": trial_index, "payload": payload})

    def gather_results(self, round_index: int,
                       trial_indices: Sequence[int],
                       timeout_s: float = 86400.0,
                       poll_s: float = 0.25) -> dict:
        deadline = time.time() + timeout_s
        pending = {int(index) for index in trial_indices}
        out: dict = {}
        while pending:
            fetched = self._rpc({"op": "fetch", "round": round_index,
                                 "trials": sorted(pending)})["results"]
            for key, payload in fetched.items():
                out[int(key)] = payload
                pending.discard(int(key))
            if pending:
                if time.time() > deadline:
                    raise TimeoutError(
                        f"trials never finished: {sorted(pending)}")
                time.sleep(poll_s)
        return out


class FileTrialCoordinator:
    """Atomic cross-process trial dispatch over a shared filesystem.

    Processes race to claim trial indices by exclusive file creation
    (``O_CREAT | O_EXCL`` — atomic on POSIX and on the NFS mounts TPU
    pods share); results are JSON files next to the claims. Mirrors the
    role of the reference's parallel optuna trials backed by a shared
    RDB (``study.py:134-148``) without requiring a database server.

    A claim whose result has not been published within ``claim_ttl_s``
    seconds is considered orphaned (crashed worker) and may be stolen:
    the stale claim file is atomically renamed aside (only one stealer's
    rename succeeds) and re-created by the winner.
    """

    def __init__(self, coordination_dir: str,
                 claim_ttl_s: float = DEFAULT_CLAIM_TTL_S) -> None:
        self.root = coordination_dir
        self.claim_ttl_s = float(claim_ttl_s)
        os.makedirs(self.root, exist_ok=True)

    def _claim_path(self, round_index: int, trial_index: int) -> str:
        return os.path.join(self.root,
                            f"claim_r{round_index}_t{trial_index}")

    def _result_path(self, round_index: int, trial_index: int) -> str:
        return os.path.join(self.root,
                            f"result_r{round_index}_t{trial_index}.json")

    def try_claim(self, round_index: int, trial_index: int) -> bool:
        """Atomically claims a trial; True iff this process won it.

        An existing claim may be stolen when it is older than
        ``claim_ttl_s`` and its result was never published."""
        path = self._claim_path(round_index, trial_index)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            if not self._claim_is_stale(round_index, trial_index):
                return False
            # Steal the orphaned claim: exactly one stealer's rename of
            # the stale file succeeds; everyone then races the ordinary
            # exclusive re-creation.
            try:
                os.rename(path, f"{path}.stale.{uuid.uuid4().hex}")
            except OSError:
                return False
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return False
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
        return True

    def _claim_is_stale(self, round_index: int, trial_index: int) -> bool:
        if os.path.exists(self._result_path(round_index, trial_index)):
            return False
        try:
            age = time.time() - os.path.getmtime(
                self._claim_path(round_index, trial_index))
        except OSError:
            return False
        return age > self.claim_ttl_s

    def claim_iter(self, round_index: int,
                   trial_indices: Sequence[int]) -> Iterator[int]:
        """Yields the trial indices this process wins for a round."""
        for index in trial_indices:
            if self.try_claim(round_index, index):
                yield index

    def publish_result(self, round_index: int, trial_index: int,
                       payload: dict) -> None:
        """Atomically publishes a trial result (write + rename)."""
        path = self._result_path(round_index, trial_index)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as handle:
            json.dump(payload, handle)
        os.replace(tmp, path)

    def gather_results(self, round_index: int,
                       trial_indices: Sequence[int],
                       timeout_s: float = 86400.0,
                       poll_s: float = 0.25) -> dict:
        """Blocks until every trial of the round has a published result;
        returns ``{trial_index: payload}``."""
        deadline = time.time() + timeout_s
        out: dict = {}
        pending = set(trial_indices)
        while pending:
            for index in list(pending):
                path = self._result_path(round_index, index)
                if os.path.exists(path):
                    with open(path, "r", encoding="utf-8") as handle:
                        out[index] = json.load(handle)
                    pending.discard(index)
            if pending:
                if time.time() > deadline:
                    raise TimeoutError(
                        f"trials never finished: {sorted(pending)}")
                time.sleep(poll_s)
        return out
