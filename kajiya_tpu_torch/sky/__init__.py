from .atmosphere import sky_radiance, atmosphere_sun_transmittance
