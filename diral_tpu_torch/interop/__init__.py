"""External-simulator interop of the port (diral_tpu/interop): the
agent<->network-simulator process boundary, and online serving over it.

* ``wire`` -- a hand-written proto2 codec for the agent protocol's 11
  messages (diral_tpu/interop/ma_messages.proto), byte for byte
  protobuf's, so the port needs no protobuf runtime;
* ``transport`` -- REQ/REP-pattern framed TCP sockets, or real libzmq
  through pyzmq (``zmq``, imported only when asked for);
* ``bridge`` -- the agent-side bridge, API-compatible with the reference
  ``RealNeSZmqBridge``;
* ``gateway_env`` -- the RealnessEnv equivalent (state assembly from
  piggybacked neighbor tables, PRR reward mapping, simulator process
  control);
* ``cpp/realnes_sim.cc`` + ``cpp/wire.h`` -- the C++ toy-RealNeS stand-in,
  built with g++ alone into build/diral_tpu_torch/ at first use;
* ``serve`` -- the serving loops (PS-DRQN, PS-DQN, SPS, and the online
  DIRAL-vs-SPS comparison), with the learner on the run's device.

The serving path launches none of the port's CUDA kernels: its nets are
a GRU and dense layers in plain PyTorch, its histograms numpy.
"""
