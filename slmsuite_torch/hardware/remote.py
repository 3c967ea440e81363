r"""
TCP transport for remote hardware: serve SLMs and cameras on a lab
machine, drive them from a control machine.

Protocol (parity: reference ``slmsuite/hardware/remote.py``): JSON
messages, URL-quoted, newline-delimited, with numpy arrays inline as
zlib+base64 blobs; a strict command allowlist on the server
(``_set_phase_hw``, ``_get_image_hw``, exposure, flush, pickle, ping).

This is host-side distribution (cameras and SLMs are host peripherals);
device-side scale-out is :mod:`slmsuite_torch.parallel`. The protocol is
the JAX package's, byte for byte, so that either package's clients talk to
either package's :class:`Server`; a tensor travels as the numpy array of
its values.
"""

import base64
import json
import socket
import time
import traceback
import urllib.parse as urllib
import warnings
import zlib
from datetime import date, datetime, timedelta

import numpy as np

from slmsuite_torch import __version__
from slmsuite_torch.hardware import _Picklable
from slmsuite_torch.misc.host import as_numpy

DEFAULT_HOST = "localhost"
DEFAULT_PORT = 5025  # Commonly used for instrument control.
DEFAULT_TIMEOUT = 5
SERVER_WAIT_TIMEOUT = 0.5

_DELIM = "\n"


# --------------------------------------------------------------------------
# Codec.
# --------------------------------------------------------------------------


class _NpEncoder(json.JSONEncoder):
    """JSON encoder handling numpy scalars/arrays (zlib+base64) and datetimes."""

    def default(self, obj):
        if hasattr(obj, "detach"):
            obj = as_numpy(obj)  # A tensor travels as its numpy array.
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.ndarray):
            return {
                "__zlib__": base64.b64encode(zlib.compress(obj.tobytes())).decode(),
                "__shape__": obj.shape,
                "__dtype__": str(obj.dtype),
            }
        if isinstance(obj, (datetime, date)):
            return obj.isoformat()
        if isinstance(obj, timedelta):
            return str(obj)
        if isinstance(obj, np.dtype):
            return {"__dtype__": str(obj)}
        return super().default(obj)


def _recurse_decompress(msg):
    """Rebuild numpy arrays from the serialized form, recursively."""
    if isinstance(msg, dict):
        if "__zlib__" in msg and len(msg) == 3:
            return np.frombuffer(
                zlib.decompress(base64.b64decode(msg["__zlib__"])),
                dtype=np.dtype(msg["__dtype__"]),
            ).reshape(msg["__shape__"])
        if "__dtype__" in msg and len(msg) == 1:
            return np.dtype(msg["__dtype__"])
        for key in msg:
            msg[key] = _recurse_decompress(msg[key])
    elif isinstance(msg, list):
        for i, item in enumerate(msg):
            msg[i] = _recurse_decompress(item)
    return msg


def _encode(payload):
    return (urllib.quote_plus(json.dumps(payload, cls=_NpEncoder)) + _DELIM).encode()


def _recv(sock, timeout):
    """Receive until the delimiter (or timeout); returns the decoded message."""
    recv_buffer = 4096 * 64
    buffer = ""
    start = time.time()

    while time.time() - start < timeout:
        data = sock.recv(recv_buffer).decode()
        buffer += data
        if data and data[-1] == _DELIM:
            msg = json.loads(urllib.unquote_plus(buffer[: -len(_DELIM)]))
            return _recurse_decompress(msg)

    return False, f"Timeout: {len(buffer)} bytes received."


# --------------------------------------------------------------------------
# Server.
# --------------------------------------------------------------------------


class Server:
    """
    Hosts hardware over TCP with a strict command allowlist. Interface with
    :class:`~slmsuite_torch.hardware.slms.remote.RemoteSLM` and
    :class:`~slmsuite_torch.hardware.cameras.remote.RemoteCamera`.
    """

    def __init__(self, hardware, port=DEFAULT_PORT, timeout=SERVER_WAIT_TIMEOUT, allowlist=None):
        """
        Parameters
        ----------
        hardware : list
            Hardware objects (cameras/SLMs) to serve; names must be unique.
        port : int
            Port in [1024, 65535]; defaults to 5025.
        timeout : float
            Accept-loop timeout in seconds.
        allowlist : list of str OR None
            Client IPs allowed to connect (None = all; note IPs can be
            spoofed — this is modest security only).
        """
        for hw in hardware:
            if not hasattr(hw, "name"):
                raise ValueError(f"Hardware {hw} must have a 'name' attribute.")
            if self.identify_hardware(hw) is None:
                raise ValueError(f"Hardware {hw.name} must be a camera or an SLM.")

        names = [hw.name for hw in hardware]
        if len(set(names)) != len(names):
            raise ValueError(f"Hardware names must be unique. Found {names}.")

        self.hardware = {hw.name: hw for hw in hardware}
        self.kind = {hw.name: self.identify_hardware(hw) for hw in hardware}

        if not (1024 <= port <= 65535):
            raise ValueError(f"Invalid port number: {port}.")
        self.port = port
        self.timeout = timeout
        self.allowlist = allowlist

        self.allowcommands = [
            "pickle",
            "flush",
            "_set_phase_hw",
            "_set_exposure_hw",
            "_get_exposure_hw",
            "_get_image_hw",
            "_get_images_hw",
        ]

    @staticmethod
    def identify_hardware(hw):
        """``"camera"``, ``"slm"``, or ``None``."""
        if hasattr(hw, "_get_image_hw"):
            return "camera"
        if hasattr(hw, "_set_phase_hw"):
            return "slm"
        return None

    def listen(self, verbose=True, max_requests=None):
        """
        Blocking accept loop: receive one message per connection, dispatch,
        reply. Per-request exceptions are returned as tracebacks without
        killing the server. ``max_requests`` bounds the loop (testing).
        """
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.settimeout(self.timeout)
        sock.bind(("", self.port))
        sock.listen(5)

        if verbose:
            print(f"Hosting on port {self.port} with hardware {list(self.hardware.keys())}")

        handled = 0
        connection = None
        try:
            while max_requests is None or handled < max_requests:
                try:
                    connection, client_addr = sock.accept()

                    if self.allowlist is not None and client_addr[0] not in self.allowlist:
                        result = (False, f"Client {client_addr} not in allowlist.")
                    else:
                        message = _recv(connection, self.timeout)
                        result = self._handle(message, client_addr, verbose)

                    connection.sendall(_encode(result))
                    connection.close()
                    handled += 1
                except socket.timeout:
                    continue
                except IOError:
                    continue
        except KeyboardInterrupt:
            if verbose:
                print("Closing server! Goodbye!")
        finally:
            try:
                if connection is not None:
                    connection.close()
            except Exception:
                pass
            sock.close()

    def _handle(self, message, client_addr=None, verbose=False):
        """Dispatch one message; returns ``(success, payload)``."""
        try:
            name = message.pop("name", None)
            command = message.pop("command", None)
            args = message.pop("args", [])
            kwargs = message.pop("kwargs", {})

            if verbose:
                print(f"{datetime.now()} {client_addr} {name}.{command}")

            if command is None:
                return False, "No command provided."
            if command == "ping":
                return True, self.kind

            if name not in self.hardware:
                return (
                    False,
                    f"Did not recognize hardware '{name}'. "
                    f"Options: {list(self.hardware.keys())}.",
                )

            if command in self.allowcommands and hasattr(self.hardware[name], command):
                attribute = getattr(self.hardware[name], command)
                if callable(attribute):
                    return True, attribute(*args, **kwargs)
                return False, f"{name}.{command} is not callable."
            return False, f"{name}.{command} not present."
        except Exception:
            return False, traceback.format_exc()


# --------------------------------------------------------------------------
# Client.
# --------------------------------------------------------------------------


class _Client(_Picklable):
    """Shared client: connect, ping, measure latency, verify version."""

    def __init__(self, name, kind, host=DEFAULT_HOST, port=DEFAULT_PORT, timeout=DEFAULT_TIMEOUT):
        self.name = name
        self.host = host
        self.port = port
        self.timeout = timeout

        hardware = self._com(command="ping")
        if self.name not in hardware:
            raise ValueError(
                f"Hardware '{self.name}' is not present at {self.host}:{self.port}. "
                f"Options: {hardware}."
            )
        if hardware[self.name] != kind:
            raise ValueError(f"Hardware '{self.name}' is not a {kind} at {self.host}:{self.port}.")

        start = time.perf_counter()
        pickled = self._com(command="pickle", kwargs=dict(attributes=False, metadata=True))
        self.latency_s = time.perf_counter() - start
        self.server_attributes = pickled

        if "__version__" not in pickled:
            warnings.warn("Server did not provide version information.")
        elif pickled["__version__"] != __version__:
            warnings.warn(
                f"Client version {__version__} does not match server "
                f"version {pickled['__version__']}."
            )

    def _com(self, command="ping", args=[], kwargs={}):
        return _Client._communicate(
            self.name, self.host, self.port, self.timeout, command, args, kwargs
        )

    @staticmethod
    def _communicate(name, host, port, timeout, command="ping", args=[], kwargs={}):
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        try:
            sock.connect((host, port))
        except (TimeoutError, ConnectionRefusedError):
            raise ValueError(f"An slmsuite server is not active at {host}:{port}.")

        sock.sendall(
            _encode({"name": name, "command": command, "args": args, "kwargs": kwargs})
        )

        try:
            success, reply = _recv(sock, timeout)
            if success is False:
                raise RuntimeError(
                    f"Server {host}:{port} communication failed. Message:\n{reply}"
                )
        finally:
            sock.close()

        return reply

    @staticmethod
    def info(host=DEFAULT_HOST, port=DEFAULT_PORT, timeout=DEFAULT_TIMEOUT, verbose=True):
        """Discover hardware hosted at ``host:port``; returns ``{name: kind}``."""
        try:
            hardware = _Client._communicate(None, host, port, timeout, command="ping")
        except (TimeoutError, ConnectionRefusedError):
            raise TimeoutError(f"Did not find a server at {host}:{port}.")

        if verbose:
            if len(hardware) == 0:
                print(f"Server found at {host}:{port} with no hardware.")
            else:
                print(
                    f"Server found at {host}:{port} with hardware:\n    "
                    + "\n    ".join(list(hardware.keys()))
                )
        return hardware
