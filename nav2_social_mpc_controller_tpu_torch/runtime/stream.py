"""Host-side streaming runtime: sensor caches and a fixed-rate controller
loop.

Reference parity target: the ROS-side concurrency layer (SURVEY.md section
2.3) — PeopleInterface / ObstacleDistInterface are mutex-guarded
latest-value caches fed by DDS subscription callbacks
(people_interface.cpp:16-29, obstacle_distance_interface.cpp:27-51), and the
Nav2 controller_server drives computeVelocityCommands at controller_frequency
(20 Hz, params/params.yaml:4).

Here the functional core removes the shared-mutable-state hazard class
(SURVEY.md section 5.2): sensor feeds write into LatestValueCache (a lock +
swap), and ControllerLoop snapshots every cache at tick start, assembles a
Scenario, and calls the step — the port's ``controller.make_step`` (one
robot, on the card unless built for the CPU), or ``make_step_batch`` for a
scenario batch per tick.
"""

import threading
import time
from typing import Any, Callable, Optional

from nav2_social_mpc_controller_tpu_torch.core.types import Scenario


class LatestValueCache:
    """Thread-safe latest-value cell (SensorDataQoS analogue: new samples
    overwrite, readers get the freshest)."""

    def __init__(self, initial: Any = None):
        self._lock = threading.Lock()
        self._value = initial
        self._stamp = time.monotonic() if initial is not None else None

    def put(self, value: Any) -> None:
        with self._lock:
            self._value = value
            self._stamp = time.monotonic()

    def get(self):
        """Returns (value, age_seconds) — value may be None before the first
        sample."""
        with self._lock:
            if self._stamp is None:
                return None, None
            return self._value, time.monotonic() - self._stamp


class ControllerLoop:
    """Fixed-rate control loop: snapshot sensors -> assemble Scenario ->
    step -> publish command via callback.

    scenario_fn: () -> Scenario | None (None = skip tick, like a TF miss)
    on_command:  (cmd, aux) -> None
    """

    def __init__(
        self,
        step_fn: Callable,
        carry,
        scenario_fn: Callable[[], Optional[Scenario]],
        on_command: Callable,
        frequency_hz: float = 20.0,
    ):
        self._step = step_fn
        self._carry = carry
        self._scenario_fn = scenario_fn
        self._on_command = on_command
        self._period = 1.0 / frequency_hz
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        self.missed = 0  # ticks skipped for missing inputs
        self.overruns = 0  # ticks whose compute exceeded the period

    def _run(self):
        next_deadline = time.monotonic()
        while not self._stop.is_set():
            next_deadline += self._period
            scenario = self._scenario_fn()
            if scenario is None:
                self.missed += 1
            else:
                cmd, aux, self._carry = self._step(scenario, self._carry)
                self._on_command(cmd, aux)
                self.ticks += 1
            now = time.monotonic()
            if now > next_deadline:
                self.overruns += 1
                next_deadline = now  # resync after overrun
            else:
                self._stop.wait(next_deadline - now)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def carry(self):
        return self._carry
