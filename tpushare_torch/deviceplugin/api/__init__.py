"""The kubelet device-plugin API (v1beta1): the generated messages of
``deviceplugin.proto``; the service plumbing is hand-written in
:mod:`tpushare_torch.deviceplugin.kubelet`."""
