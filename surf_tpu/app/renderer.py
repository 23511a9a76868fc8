"""Renderer orchestration facade.

Mirrors the reference's renderer interface (IRenderer:
clearAccumulator / render(deltaTime) / config() / frameInfo(),
reference/headers/renderer.h:87-97) so users of the reference find
the same surface here.  `WavefrontRenderer` is the analog of
WaveFrontRenderer (renderer.h:207-436); `OracleRendererFacade` wraps the
NumPy oracle the way `Renderer` wraps the CPU path."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RendererConfigHost:
    """RendererConfig (renderer.h:24-28)."""

    max_bounces: int | None = None   # None = unbounded (RR-terminated)
    samples_per_frame: int = 1


@dataclass
class FrameInstrumentationData:
    """FrameInstrumentationData (renderer.h:30-34)."""

    energy: float = 0.0
    total_samples: int = 0


class WavefrontRenderer:
    """Progressive wavefront renderer over a compiled scene."""

    def __init__(self, host_compiled, camera, config: RendererConfigHost,
                 compact: bool = False, defer: bool = False,
                 wave_limit: int | None = None):
        import jax

        from ..scene.camera import CameraParams
        from ..wavefront.integrator import RenderConfig

        self._host = host_compiled
        self._camera = camera
        self._config = config
        self._cam_params = CameraParams.from_camera(camera)
        self._rcfg = RenderConfig.for_scene(
            host_compiled.static, camera.screen_width, camera.screen_height,
            config.samples_per_frame,
            use_defocus=camera.defocus_angle != 0.0,
            max_bounces=config.max_bounces,
        )._replace(compact=compact)
        if wave_limit is not None:
            self._rcfg = self._rcfg._replace(wave_limit=wave_limit)
        from ..wavefront.accumulator import Accumulator

        self._acc = Accumulator(camera.screen_width, camera.screen_height)
        self._frame_info = FrameInstrumentationData()
        self._scene_dev = jax.device_put(host_compiled.render_scene)
        # Cross-frame deferral (renderer.cpp:1101-1104): capped-out paths
        # persist in a FrameCarry and resume next frame, so an aggressive
        # wave cap costs zero estimator bias (the tail is processed pooled
        # at high occupancy instead of per sample).
        self._defer = defer
        self._carry = None
        if defer:
            from ..wavefront.integrator import empty_frame_carry

            self._carry = empty_frame_carry(self._rcfg)

    # -- IRenderer surface (renderer.h:87-97) ------------------------------
    def clear_accumulator(self) -> None:
        self._acc.clear()

    def config(self) -> RendererConfigHost:
        return self._config

    def frame_info(self) -> FrameInstrumentationData:
        return self._frame_info

    def render(self, delta_time: float = 0.0) -> np.ndarray:
        """One frame of samples_per_frame samples; returns the resolved
        (accumulated / totalSamples) image."""
        import jax
        import jax.numpy as jnp

        if self._defer:
            from ..wavefront.integrator import (
                initial_seeds,
                render_frame_carry_jit,
            )

            seed0 = initial_seeds(
                self._rcfg, jnp.uint32(self._acc.total_samples))
            radiance, _, self._carry = render_frame_carry_jit(
                self._scene_dev, self._rcfg, self._cam_params, seed0,
                self._carry,
            )
        else:
            from ..wavefront.integrator import render_frame_jit

            radiance = render_frame_jit(
                self._scene_dev, self._rcfg, self._cam_params,
                jnp.uint32(self._acc.total_samples),
            )
        self._acc.add_frame(
            np.asarray(jax.block_until_ready(radiance)),
            self._config.samples_per_frame,
        )
        self._frame_info.energy = self._acc.energy()
        self._frame_info.total_samples = self._acc.total_samples
        return self._acc.resolve()

    def notify_camera_changed(self) -> None:
        """Camera/UI change invalidates the accumulator (main.cpp:411-419)
        and any deferred paths (they belong to the discarded frames)."""
        from ..scene.camera import CameraParams

        self._cam_params = CameraParams.from_camera(self._camera)
        self.clear_accumulator()
        if self._defer:
            from ..wavefront.integrator import empty_frame_carry

            self._carry = empty_frame_carry(self._rcfg)


class OracleRendererFacade:
    """The CPU-path analog (renderer.h:99-205) over the NumPy oracle."""

    def __init__(self, host_compiled, camera, config: RendererConfigHost):
        from ..reference.cpu_renderer import OracleRenderer

        self._renderer = OracleRenderer(host_compiled, camera)
        self._camera = camera
        self._config = config
        from ..wavefront.accumulator import Accumulator

        self._acc = Accumulator(camera.screen_width, camera.screen_height)
        self._frame_info = FrameInstrumentationData()

    def clear_accumulator(self) -> None:
        self._acc.clear()

    def config(self) -> RendererConfigHost:
        return self._config

    def frame_info(self) -> FrameInstrumentationData:
        return self._frame_info

    def render(self, delta_time: float = 0.0) -> np.ndarray:
        radiance = self._renderer.render(
            self._camera.screen_width, self._camera.screen_height,
            self._config.samples_per_frame, self._acc.total_samples,
        )
        self._acc.add_frame(radiance, self._config.samples_per_frame)
        self._frame_info.energy = self._acc.energy()
        self._frame_info.total_samples = self._acc.total_samples
        return self._acc.resolve()
