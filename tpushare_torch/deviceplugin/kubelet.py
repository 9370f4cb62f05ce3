"""kubelet <-> plugin gRPC plumbing (device-plugin API v1beta1) for the
port's device plugin.

The twin of ``tpushare/deviceplugin/kubelet.py``: the plugin registers
with kubelet's ``Registration`` service, then serves the ``DevicePlugin``
service (the ListAndWatch capacity stream, Allocate and
GetPreferredAllocation) on a unix socket a resource. It holds:

* hand-written stubs and servicer registration over the generated
  messages in :mod:`.api.deviceplugin_pb2` (the service plumbing is a
  page of code against the stable wire contract);
* :class:`DevicePluginServicer`, which puts a
  :class:`~tpushare_torch.deviceplugin.plugin.TPUSharePlugin` on the wire,
  one a resource (HBM GiB, whole cards);
* :class:`PluginServer` and :func:`run_node_daemon`, the node daemon:
  annotate the node, serve both resources, register each;
* :class:`FakeKubelet`: a real Registration server and a driver that
  calls the plugin back as kubelet does.

Of the daemon's modules only this one, the generated messages and the
daemon's main import ``grpc`` or ``protobuf``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent import futures

import grpc

from tpushare_torch.deviceplugin.api import deviceplugin_pb2 as pb
from tpushare_torch.deviceplugin.plugin import AllocateError, TPUSharePlugin
from tpushare_torch.k8s.errors import ApiError
from tpushare_torch.utils import const

log = logging.getLogger(__name__)

API_VERSION = "v1beta1"
DEVICE_PLUGIN_PATH = "/var/lib/kubelet/device-plugins"
KUBELET_SOCKET = "kubelet.sock"

_SERVICE_DP = "v1beta1.DevicePlugin"
_SERVICE_REG = "v1beta1.Registration"


# ---------------------------------------------------------------------------
# Hand-written stubs (what grpc_tools would generate)
# ---------------------------------------------------------------------------

class DevicePluginStub:
    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            f"/{_SERVICE_DP}/GetDevicePluginOptions",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString)
        self.ListAndWatch = channel.unary_stream(
            f"/{_SERVICE_DP}/ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString)
        self.GetPreferredAllocation = channel.unary_unary(
            f"/{_SERVICE_DP}/GetPreferredAllocation",
            request_serializer=(
                pb.PreferredAllocationRequest.SerializeToString),
            response_deserializer=pb.PreferredAllocationResponse.FromString)
        self.Allocate = channel.unary_unary(
            f"/{_SERVICE_DP}/Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString)
        self.PreStartContainer = channel.unary_unary(
            f"/{_SERVICE_DP}/PreStartContainer",
            request_serializer=pb.PreStartContainerRequest.SerializeToString,
            response_deserializer=pb.PreStartContainerResponse.FromString)


class RegistrationStub:
    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            f"/{_SERVICE_REG}/Register",
            request_serializer=pb.RegisterRequest.SerializeToString,
            response_deserializer=pb.Empty.FromString)


def add_device_plugin_servicer(servicer, server: grpc.Server) -> None:
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.DevicePluginOptions.SerializeToString),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.ListAndWatchResponse.SerializeToString),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=pb.PreferredAllocationRequest.FromString,
            response_serializer=(
                pb.PreferredAllocationResponse.SerializeToString)),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=pb.AllocateRequest.FromString,
            response_serializer=pb.AllocateResponse.SerializeToString),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=pb.PreStartContainerRequest.FromString,
            response_serializer=pb.PreStartContainerResponse.SerializeToString),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVICE_DP, handlers),))


def add_registration_servicer(servicer, server: grpc.Server) -> None:
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=pb.Empty.SerializeToString),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVICE_REG, handlers),))


# ---------------------------------------------------------------------------
# Plugin-side servicer
# ---------------------------------------------------------------------------

def _to_pb_devices(devices) -> list[pb.Device]:
    out = []
    for d in devices:
        dev = pb.Device(ID=d.id, health=d.health)
        if d.numa_node >= 0:
            dev.topology.nodes.add(ID=d.numa_node)
        out.append(dev)
    return out


def _to_pb_allocation(alloc) -> pb.ContainerAllocateResponse:
    resp = pb.ContainerAllocateResponse()
    for k, v in alloc.envs.items():
        resp.envs[k] = v
    for host_path, container_path in alloc.devices:
        resp.devices.add(host_path=host_path, container_path=container_path,
                         permissions="rw")
    for host_path, container_path, read_only in alloc.mounts:
        resp.mounts.add(host_path=host_path, container_path=container_path,
                        read_only=read_only)
    for k, v in alloc.annotations.items():
        resp.annotations[k] = v
    return resp


class DevicePluginServicer:
    """One advertised resource (HBM GiB or whole cards) on the wire."""

    def __init__(self, plugin: TPUSharePlugin, resource: str,
                 poll_interval: float = 5.0):
        if resource not in (const.HBM_RESOURCE, const.CHIP_RESOURCE):
            raise ValueError(f"unknown resource {resource}")
        self.plugin = plugin
        self.resource = resource
        self.poll_interval = poll_interval
        self.stop_event = threading.Event()

    def _devices(self):
        return (self.plugin.hbm_devices()
                if self.resource == const.HBM_RESOURCE
                else self.plugin.chip_devices())

    # -- rpc methods ----------------------------------------------------- #

    def GetDevicePluginOptions(self, request, context):
        return pb.DevicePluginOptions(
            pre_start_required=False,
            get_preferred_allocation_available=True)

    def ListAndWatch(self, request, context):
        """Initial full device list, then re-send whenever health flips
        (kubelet keeps this stream open for the plugin's lifetime)."""
        last = None
        while not self.stop_event.is_set():
            devices = self._devices()
            snapshot = [(d.id, d.health) for d in devices]
            if snapshot != last:
                last = snapshot
                yield pb.ListAndWatchResponse(devices=_to_pb_devices(devices))
            if self.stop_event.wait(self.poll_interval):
                return
            if not context.is_active():
                return

    def GetPreferredAllocation(self, request, context):
        """Prefer the ids the extender planned for the next pending pod
        (its chip-idx annotation), then sorted order, so kubelet's pick
        is the extender's placement."""
        resp = pb.PreferredAllocationResponse()
        batch = [(list(creq.available_deviceIDs), creq.allocation_size)
                 for creq in request.container_requests]
        preferred_per = self.plugin.preferred_ids_batch(self.resource,
                                                        batch)
        for creq, preferred in zip(request.container_requests,
                                   preferred_per):
            keep = list(creq.must_include_deviceIDs)
            for cid in preferred + sorted(creq.available_deviceIDs):
                if len(keep) >= creq.allocation_size:
                    break
                if cid not in keep:
                    keep.append(cid)
            resp.container_responses.add(deviceIDs=keep)
        return resp

    def Allocate(self, request, context):
        requests = [list(creq.devicesIDs)
                    for creq in request.container_requests]
        try:
            # Every container is matched before anything mutates, so a
            # failure aborts the RPC with no side effect.
            if self.resource == const.HBM_RESOURCE:
                allocs = self.plugin.allocate_hbm_batch(requests)
            else:
                allocs = self.plugin.allocate_chips_batch(requests)
        except (AllocateError, ApiError) as exc:
            # ApiError: the commit raced a deletion (NotFoundError) or
            # lost its conflict retries (ConflictError); kubelet retries.
            context.abort(grpc.StatusCode.INTERNAL, str(exc))
        resp = pb.AllocateResponse()
        for alloc in allocs:
            resp.container_responses.append(_to_pb_allocation(alloc))
        return resp

    def PreStartContainer(self, request, context):
        return pb.PreStartContainerResponse()


# ---------------------------------------------------------------------------
# Node daemon: serve + register
# ---------------------------------------------------------------------------

def socket_name(resource: str) -> str:
    return resource.replace("/", "-").replace(".", "-") + ".sock"


class PluginServer:
    """Serves one DevicePluginServicer on a unix socket and registers it
    with kubelet."""

    def __init__(self, servicer: DevicePluginServicer,
                 plugin_dir: str = DEVICE_PLUGIN_PATH):
        self.servicer = servicer
        self.plugin_dir = plugin_dir
        self.endpoint = socket_name(servicer.resource)
        self.socket_path = os.path.join(plugin_dir, self.endpoint)
        self._server: grpc.Server | None = None

    def start(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        add_device_plugin_servicer(self.servicer, server)
        server.add_insecure_port(f"unix://{self.socket_path}")
        server.start()
        self._server = server
        log.info("device plugin serving %s on %s",
                 self.servicer.resource, self.socket_path)

    def register(self, kubelet_socket: str | None = None) -> None:
        target = kubelet_socket or os.path.join(self.plugin_dir,
                                                KUBELET_SOCKET)
        with grpc.insecure_channel(f"unix://{target}") as channel:
            RegistrationStub(channel).Register(pb.RegisterRequest(
                version=API_VERSION,
                endpoint=self.endpoint,
                resource_name=self.servicer.resource,
                options=pb.DevicePluginOptions(
                    get_preferred_allocation_available=True)))
        log.info("registered %s with kubelet at %s",
                 self.servicer.resource, target)

    def stop(self, grace: float = 0.5) -> None:
        self.servicer.stop_event.set()
        if self._server is not None:
            self._server.stop(grace).wait()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


def run_node_daemon(node_name: str, client, inventory,
                    plugin_dir: str = DEVICE_PLUGIN_PATH,
                    kubelet_socket: str | None = None,
                    poll_interval: float = 5.0,
                    usage_dir: str = const.USAGE_DIR_DEFAULT,
                    devfs_root: str = "/dev") -> list[PluginServer]:
    """The node's bootstrap: annotate the node, then serve and register
    both resources. The partial-grant checkpoint lives in
    ``plugin_dir``."""
    plugin = TPUSharePlugin(node_name, client, inventory,
                            state_dir=plugin_dir, usage_dir=usage_dir,
                            devfs_root=devfs_root)
    plugin.annotate_node()
    servers = []
    for resource in (const.HBM_RESOURCE, const.CHIP_RESOURCE):
        server = PluginServer(
            DevicePluginServicer(plugin, resource, poll_interval),
            plugin_dir=plugin_dir)
        server.start()
        server.register(kubelet_socket)
        servers.append(server)
    return servers


# ---------------------------------------------------------------------------
# Fake kubelet (tests)
# ---------------------------------------------------------------------------

class FakeKubelet:
    """The Registration endpoint, and the calls kubelet makes back to a
    plugin."""

    def __init__(self, plugin_dir: str):
        self.plugin_dir = plugin_dir
        self.registrations: list[pb.RegisterRequest] = []
        self.socket_path = os.path.join(plugin_dir, KUBELET_SOCKET)
        self._server: grpc.Server | None = None

    # Registration service
    def Register(self, request, context):
        self.registrations.append(request)
        return pb.Empty()

    def start(self) -> None:
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        add_registration_servicer(self, server)
        server.add_insecure_port(f"unix://{self.socket_path}")
        server.start()
        self._server = server

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(0.2).wait()

    # -- kubelet-side drives --------------------------------------------- #

    def _channel(self, endpoint: str) -> grpc.Channel:
        return grpc.insecure_channel(
            f"unix://{os.path.join(self.plugin_dir, endpoint)}")

    def snapshot_devices(self, endpoint: str,
                         timeout: float = 5.0) -> list[pb.Device]:
        """First ListAndWatch frame, like kubelet's initial sync."""
        with self._channel(endpoint) as channel:
            stream = DevicePluginStub(channel).ListAndWatch(
                pb.Empty(), timeout=timeout)
            frame = next(iter(stream))
            stream.cancel()
            return list(frame.devices)

    def allocate(self, endpoint: str,
                 device_ids: list[str]) -> pb.AllocateResponse:
        with self._channel(endpoint) as channel:
            return DevicePluginStub(channel).Allocate(
                pb.AllocateRequest(
                    container_requests=[
                        pb.ContainerAllocateRequest(devicesIDs=device_ids)]),
                timeout=5.0)

    def preferred(self, endpoint: str, available: list[str],
                  size: int) -> list[str]:
        """GetPreferredAllocation for one container, as kubelet asks it
        before Allocate."""
        with self._channel(endpoint) as channel:
            resp = DevicePluginStub(channel).GetPreferredAllocation(
                pb.PreferredAllocationRequest(container_requests=[
                    pb.ContainerPreferredAllocationRequest(
                        available_deviceIDs=available,
                        allocation_size=size)]),
                timeout=5.0)
        return list(resp.container_responses[0].deviceIDs)


def wait_for(predicate, timeout: float = 5.0, interval: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False
